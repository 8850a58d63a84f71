"""Parameter / optimizer / decode-state / batch specs and their placement
(port of :mod:`repro.launch.sharding`).

Specs are inferred *by leaf name* (the last dict key on the tree path) so
one rule table covers every architecture family, the stacked layer layout
(leading ``n_scan`` dim) and the mirrored AdamW moments.  Logical axis
names resolve through :func:`repro_torch.launch.mesh.logical_rules` and
are dropped per dim when the dim is not divisible by the mesh axis via
:func:`repro_torch.models.common.sanitize_dim`.  The tables are the
reference's, so a port tree on the ``meta`` device gets the reference's
specs leaf for leaf.

Placement (:func:`device_put` of a :class:`NamedSharding`) cuts each dim
that a spec entry names into equal contiguous blocks, one per coordinate of
the named mesh axes, and copies every block to its device; a dim the spec
leaves ``None`` stays whole (``P()`` replicates the leaf: one copy per
device).  A placed leaf is a :class:`Sharded`: its blocks in the order of
``mesh.devices.flat``.  The fleet rule (:func:`shard_fleet_config`) pads
the device axis ``D`` to a multiple of ``mesh.size`` by wrap-around (index
``arange(D + pad) % D``, the reference's) and cuts it into ``mesh.size``
blocks: block ``i`` lives on ``mesh.devices.flat[i]``.  A run over such a
placement computes each block on its own device, in block order
(:func:`blocks`), and :func:`join` gathers the results onto the first
device in that order; a sum across blocks runs on the first block's
device in block order (:func:`block_sum`).
On a mesh of one device a placement is the tensor itself: no padding, no
copy.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..models.common import (  # noqa: F401  (re-exported)
    Sharded, block_layout, block_sum, replace_blocks, sanitize_dim, whole_of,
)
from .mesh import Mesh, logical_rules

# --------------------------------------------------------------------------- #
# Leaf-name -> logical axes of the *trailing* dims.  Leading dims (layer
# stacking) are padded with None.  Names not listed replicate.
# --------------------------------------------------------------------------- #

PARAM_SPECS: Mapping[str, tuple] = {
    # embeddings / head
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "frontend_proj": ("embed", None),
    # attention
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None),
    "wo": ("heads", None, "embed"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    # dense FFN
    "w1": ("embed", "ff"),
    "w3": ("embed", "ff"),
    "w2": ("ff", "embed"),
    # recurrent (Griffin) block
    "gate_proj": ("embed", "ff"),
    "rec_proj": ("embed", "ff"),
    "out_proj": ("ff", "embed"),
    # RG-LRU gate weights are block-diagonal: one (w/H, w/H) block per head
    "wa": ("heads", None, None),
    "wx": ("heads", None, None),
    "ba": ("ff",),
    "bx": ("ff",),
    "lam": ("ff",),
    # xLSTM cell
    "up": ("embed", "ff"),
    "wz": ("embed", "ff"),
    "wi": ("embed", "ff"),
    "wf": ("embed", "ff"),
    "down": ("ff", "embed"),
}

# leaves under a "moe" subtree (expert-stacked weights)
MOE_SPECS: Mapping[str, tuple] = {
    "router": ("embed", None),
    "w1": ("experts", "embed", None),
    "w3": ("experts", "embed", None),
    "w2": ("experts", None, "embed"),
}


class P(tuple):
    """A partition spec: one entry per dim, each ``None`` (whole), a mesh
    axis name, or a tuple of names (the dim cut over their product, the
    first axis major; a one-name tuple is that name, as in the
    reference).  Trailing dims the spec does not reach are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding:
    """A spec over a mesh: the placement rule of one leaf."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


# --------------------------------------------------------------------------- #
# Trees: dicts (named), NamedTuples and sequences (unnamed), leaves.
# --------------------------------------------------------------------------- #


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_named(fn, tree, names=()):
    """``fn(names, leaf)`` over the leaves of ``tree``; ``names`` are the
    dict keys on the leaf's path (a NamedTuple's fields and a sequence's
    indices are not names, as in the reference's ``DictKey`` filter)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, names + (k,)) for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(*[_map_named(fn, v, names) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(fn, v, names) for v in tree)
    if tree is None:
        return None
    return fn(names, tree)


def _map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (``is_leaf`` stops the descent, as for a spec, which is a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if _is_record(tree):
        return type(tree)(*[_map(fn, *xs, is_leaf=is_leaf)
                            for xs in zip(tree, *rest)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, *xs, is_leaf=is_leaf)
                          for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


# --------------------------------------------------------------------------- #
# Parameter and optimizer specs.
# --------------------------------------------------------------------------- #


def _axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(mesh.shape)


def _leaf_spec(names, leaf, rules, axis_sizes) -> P:
    name = names[-1] if names else ""
    table = MOE_SPECS if "moe" in names else PARAM_SPECS
    base = table.get(name)
    if base is None or leaf.ndim < len(base):
        return P()
    pad = leaf.ndim - len(base)
    phys = [None] * pad
    for dim, logical in zip(leaf.shape[pad:], base):
        axes = rules.get(logical) if logical else None
        phys.append(sanitize_dim(axes, dim, axis_sizes))
    return P(*phys)


def param_specs(mesh: Mesh, params: Any) -> Any:
    """Spec tree for a params (or AdamW state) tree of tensors (``meta``
    tensors will do)."""
    rules = logical_rules(mesh)
    sizes = _axis_sizes(mesh)
    return _map_named(
        lambda names, leaf: _leaf_spec(names, leaf, rules, sizes), params)


# --------------------------------------------------------------------------- #
# Decode-state specs.
# --------------------------------------------------------------------------- #

_STATE_4D = ("k", "v", "xk", "xv")  # (..., B, C, KV, hd)


def _state_leaf_spec(names, leaf, rules, sizes, model_axis) -> P:
    name = names[-1] if names else ""
    batch_axes = rules.get("batch")
    model_size = sizes.get(model_axis, 1)

    if name in _STATE_4D:
        pad = leaf.ndim - 4
        B, C, KV, hd = leaf.shape[pad:]
        batch = sanitize_dim(batch_axes, B, sizes)
        if KV % model_size == 0:
            return P(*([None] * pad), batch, None, model_axis, None)
        if C % model_size == 0:
            # few KV heads: shard the cache length instead
            return P(*([None] * pad), batch, model_axis, None, None)
        return P(*([None] * pad), batch, None, None, None)
    if name == "h":  # RG-LRU hidden state (..., B, W)
        pad = leaf.ndim - 2
        B, W = leaf.shape[pad:]
        batch = sanitize_dim(batch_axes, B, sizes)
        width = model_axis if W % model_size == 0 else None
        return P(*([None] * pad), batch, width)
    if name == "buf":  # conv ring buffer (..., B, k-1, W)
        pad = leaf.ndim - 3
        B, _, W = leaf.shape[pad:]
        batch = sanitize_dim(batch_axes, B, sizes)
        width = model_axis if W % model_size == 0 else None
        return P(*([None] * pad), batch, None, width)
    if name == "pos":
        return P(sanitize_dim(batch_axes, leaf.shape[0], sizes))
    if name == "enc_out":
        batch = sanitize_dim(batch_axes, leaf.shape[0], sizes)
        return P(batch, None, None)
    # xLSTM cell tuples and anything unnamed: the batch is the first dim
    # divisible by the batch axes
    for i, dim in enumerate(leaf.shape):
        batch = sanitize_dim(batch_axes, dim, sizes)
        if batch is not None:
            return P(*([None] * i), batch, *([None] * (leaf.ndim - i - 1)))
    return P()


def state_specs(mesh: Mesh, state: Any) -> Any:
    rules = logical_rules(mesh)
    sizes = _axis_sizes(mesh)
    model_axis = "model" if "model" in mesh.axis_names else None
    return _map_named(
        lambda names, leaf: _state_leaf_spec(names, leaf, rules, sizes,
                                             model_axis), state)


# --------------------------------------------------------------------------- #
# Batch / token / logits specs.
# --------------------------------------------------------------------------- #


def batch_specs(mesh: Mesh, batch: Any) -> Any:
    """Input batch: the leading dim is the global batch -> data axes."""
    rules = logical_rules(mesh)
    sizes = _axis_sizes(mesh)

    def spec(leaf):
        b = sanitize_dim(rules.get("batch"), leaf.shape[0], sizes)
        return P(b, *([None] * (leaf.ndim - 1)))

    return _map(spec, batch)


def logits_spec(mesh: Mesh, batch_dim: int, vocab_dim: int, ndim: int) -> P:
    rules = logical_rules(mesh)
    sizes = _axis_sizes(mesh)
    b = sanitize_dim(rules.get("batch"), batch_dim, sizes)
    v = sanitize_dim(rules.get("vocab"), vocab_dim, sizes)
    return P(b, *([None] * (ndim - 2)), v)


def named(mesh: Mesh, spec_tree: Any) -> Any:
    """The spec tree as a tree of :class:`NamedSharding`\\ s over ``mesh``."""
    return _map(lambda s: NamedSharding(mesh, s), spec_tree,
                is_leaf=lambda s: isinstance(s, P))


# --------------------------------------------------------------------------- #
# Placement.
# --------------------------------------------------------------------------- #


def _block_slices(mesh: Mesh, spec: P, shape) -> list[tuple]:
    """Each mesh device's block of a tensor of ``shape`` under ``spec``:
    one tuple of slices per device, in ``mesh.devices.flat`` order."""
    if mesh.devices is None:
        raise ValueError("an abstract mesh holds no devices to place on")
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than the rank "
                         f"{len(shape)} of its leaf")
    sizes = mesh.shape
    entries = [(e,) if isinstance(e, str) else (e or ()) for e in spec]
    for axes in entries:
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec!r} names {a!r}, not an axis of "
                                 f"the mesh {tuple(sizes)}")
    out = []
    for i in range(mesh.size):
        coord = dict(zip(mesh.axis_names,
                         np.unravel_index(i, tuple(sizes.values()))))
        sl = []
        for dim, axes in zip(shape, entries):
            parts, idx = 1, 0
            for a in axes:
                parts *= sizes[a]
                idx = idx * sizes[a] + int(coord[a])
            if dim % parts:
                raise ValueError(f"a dim of {dim} does not divide into "
                                 f"{parts} blocks (spec {spec!r})")
            n = dim // parts
            sl.append(slice(idx * n, (idx + 1) * n))
        out.append(tuple(sl))
    return out


def _whole(x) -> torch.Tensor:
    return gather(x) if isinstance(x, Sharded) else x


def _put(leaf, sharding: NamedSharding) -> Sharded:
    leaf = _whole(leaf)
    devices = sharding.mesh.devices
    whole = tuple(slice(0, n) for n in leaf.shape)
    slices = [tuple(sl) + whole[len(sl):] for sl in
              _block_slices(sharding.mesh, sharding.spec, leaf.shape)]
    blocks = [(leaf if sl == whole else leaf[sl]).to(dev)
              for sl, dev in zip(slices, devices.flat)]
    return Sharded(blocks, sharding, leaf.shape, slices)


def device_put(tree: Any, shardings: Any) -> Any:
    """Place every leaf of ``tree`` by its :class:`NamedSharding` (one for
    every leaf, or a tree of them mirroring ``tree``)."""
    if isinstance(shardings, NamedSharding):
        return _map(lambda leaf: _put(leaf, shardings), tree)
    return _map(_put, tree, shardings)


def blocks(tree: Any) -> list:
    """The placed ``tree`` as one tree per mesh device, in
    ``mesh.devices.flat`` order (a leaf that is not :class:`Sharded`
    appears whole in every one)."""
    placed = [x for x in _leaves(tree) if isinstance(x, Sharded)]
    if not placed:
        return [tree]
    return [_map(lambda x, i=i: x.blocks[i] if isinstance(x, Sharded) else x,
                 tree) for i in range(len(placed[0].blocks))]


def gather(tree: Any) -> Any:
    """Every :class:`Sharded` leaf of ``tree`` assembled whole on the first
    device of its mesh (a one-block leaf is its block: no copy)."""
    return _map(whole_of, tree)


def join(trees: Sequence[Any]) -> Any:
    """Per-block result trees (``(D_i, ...)`` leaves) concatenated along
    the leading axis on the first block's device, in block order; one tree
    is returned as it is."""
    if len(trees) == 1:
        return trees[0]
    return _map(lambda first, *rest: torch.cat(
        [first] + [r.to(first.device) for r in rest]), *trees)


def take_rows(tree: Any, n: int) -> Any:
    """The first ``n`` rows of every leaf (the real devices of a padded
    fleet); a tree of ``n`` rows is returned as it is."""
    lead = _leaves(tree)[0].shape[0]
    if lead == n:
        return tree
    return _map(lambda x: x[:n], tree)


# --------------------------------------------------------------------------- #
# Fleet device-axis placement (repro_torch.fleet / .adapt / .serve).
# --------------------------------------------------------------------------- #


def fleet_specs(mesh: Mesh, cfg: Any) -> Any:
    """Specs for a :class:`repro_torch.fleet.state.FleetConfig` (or any tree
    of ``(D, ...)`` leaves, the segment carry included): the leading device
    axis over the whole mesh, every trailing dim whole (each device steps
    its entire task set locally)."""
    axes = tuple(mesh.axis_names)
    return _map(lambda leaf: P(axes, *([None] * (leaf.ndim - 1))), cfg)


def shard_fleet_config(mesh: Mesh, cfg: Any) -> Any:
    """Place a FleetConfig with its device axis cut over ``mesh``.

    ``D`` is padded up to a multiple of ``mesh.size`` by wrapping around
    the existing devices (every block then holds valid configs); callers
    slice results back to the real device count."""
    cfg = _map(_whole, cfg)
    d = _leaves(cfg)[0].shape[0]
    pad = (-d) % mesh.size
    if pad:
        idx = torch.arange(d + pad) % d
        cfg = _map(lambda leaf: leaf[idx.to(leaf.device)], cfg)
    return device_put(cfg, named(mesh, fleet_specs(mesh, cfg)))


def shard_fleet_carry(mesh: Mesh, carry: Any) -> Any:
    """Place a segment carry (or a telemetry) like a FleetConfig: the same
    wrap-around padding and the same blocks, so config and carry stay
    aligned block for block between segments."""
    return shard_fleet_config(mesh, carry)


def shard_serve_carry(mesh: Mesh, carry: Any, *,
                      shared_bank: bool = False) -> Any:
    """Place a live-serving carry (:class:`repro_torch.fleet.state
    .ServeCarry`): the device state and the log like a fleet carry; a
    per-device bank alongside them, a shared bank (no device axis)
    replicated.  The serving engine requires ``D`` to be a multiple of the
    mesh size, so no padding happens."""
    bank = carry.bank
    if shared_bank:
        bank = device_put(bank, NamedSharding(mesh, P()))
    else:
        bank = shard_fleet_config(mesh, bank)
    return carry._replace(dev=shard_fleet_config(mesh, carry.dev),
                          bank=bank,
                          log=shard_fleet_config(mesh, carry.log))


def serve_table_shardings(mesh: Mesh, tables: Any,
                          per_device: bool = False) -> Any:
    """Per-leaf :class:`NamedSharding`\\ s of a
    :class:`repro_torch.serve.fleet_engine.ServeTables`: the classifier
    metadata replicates; the feature and label tables are cut over the
    fleet axis when every device serves its own stream (``per_device``),
    else replicated."""
    batched = {"sel_feats", "full_feats", "labels"} if per_device else set()
    axes = tuple(mesh.axis_names)
    out = {}
    for name, leaf in tables._asdict().items():
        spec = (P(axes, *([None] * (leaf.ndim - 1))) if name in batched
                else P())
        out[name] = NamedSharding(mesh, spec)
    return type(tables)(**out)


def shard_serve_tables(mesh: Mesh, tables: Any,
                       per_device: bool = False) -> Any:
    """Place a ServeTables by :func:`serve_table_shardings`."""
    return device_put(tables, serve_table_shardings(mesh, tables, per_device))
