"""Shared building blocks: norms, activations, RoPE, initializers (port of
:mod:`repro.models.common`).

:func:`sanitize_dim` is the reference's rule for dropping the mesh axes a
dimension does not divide (:mod:`repro_torch.launch.sharding` infers its
specs with it).  The reference's in-model sharding constraints (``shard``,
``logical_axis_rules``) split one model over several cards and have no
counterpart yet.  Initializers draw from an explicit
:class:`torch.Generator`; their distributions and scales are the
reference's, their numbers are not (the tests carry the reference's weights
over with :func:`repro_torch.convert.transformer_params`).  A
:class:`ShapeOnly` generator draws nothing: its trees live on the ``meta``
device, with the shapes and dtypes of the real ones.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

_F32 = torch.float32

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def sanitize_dim(axes, dim: int, axis_sizes: Mapping[str, int]):
    """Drop the mesh axes a dim is not divisible by (e.g. 2 KV heads on a
    16-way model axis fall back to replication).  Axes are kept greedily in
    order, each while the product of those kept so far still divides
    ``dim``; an axis the sizes do not name counts as size 1."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    total, kept = 1, []
    for a in axes:
        sz = axis_sizes.get(a, 1)
        if dim % (total * sz) == 0:
            kept.append(a)
            total *= sz
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


# --------------------------------------------------------------------------- #
# Tensors cut into blocks over a mesh.
# --------------------------------------------------------------------------- #
#
# :mod:`repro_torch.launch.sharding` places a leaf by its spec into a
# :class:`Sharded`; the models run a placed decode state block by block
# with the helpers below, which take a plain tensor as the one block that
# holds all of it.


class Sharded:
    """A tensor placed over a mesh: ``blocks[i]`` lives on
    ``sharding.mesh.devices.flat[i]`` and holds ``slices[i]`` of the whole
    tensor (one slice per dim); ``shape`` is the whole tensor's."""

    __slots__ = ("blocks", "sharding", "shape", "slices")

    def __init__(self, blocks: Sequence[torch.Tensor], sharding, shape,
                 slices: Sequence[tuple]):
        self.blocks = tuple(blocks)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.slices = tuple(slices)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec!r}, {len(self.blocks)} blocks)")


def block_layout(x) -> list[tuple[tuple, list[int]]]:
    """The distinct blocks of a placed leaf, in the order of their first
    block: ``(slices, block indices)``, one slice per dim; blocks with the
    same slices are replicas of one another.  A plain tensor is one block
    holding all of it."""
    if not isinstance(x, Sharded):
        return [(tuple(slice(0, n) for n in x.shape), [0])]
    out: dict[tuple, list[int]] = {}
    for i, sl in enumerate(x.slices):
        out.setdefault(tuple((d.start, d.stop) for d in sl), []).append(i)
    return [(tuple(slice(a, b) for a, b in key), idx)
            for key, idx in out.items()]


def blocks_of(x) -> tuple:
    """A placed leaf's blocks; a plain tensor is its one block."""
    return x.blocks if isinstance(x, Sharded) else (x,)


def replace_blocks(x, new: Sequence[torch.Tensor]):
    """``x``'s placement with new blocks of the same shapes (a plain
    tensor's one block is the new tensor)."""
    if not isinstance(x, Sharded):
        return new[0]
    return Sharded(new, x.sharding, x.shape, x.slices)


def whole_of(x) -> torch.Tensor:
    """A placed leaf assembled whole on its first block's device (a plain
    tensor, or a leaf of one block, as it is: no copy)."""
    if not isinstance(x, Sharded):
        return x
    if len(x.blocks) == 1:
        return x.blocks[0]
    dev = x.blocks[0].device
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    for sl, b in zip(x.slices, x.blocks):
        out[sl] = b.to(dev)
    return out


def place_like(x, t: torch.Tensor):
    """A whole tensor ``t`` of ``x``'s shape cut into ``x``'s blocks on
    their devices (a plain ``x``: ``t`` itself)."""
    if not isinstance(x, Sharded):
        return t
    return replace_blocks(x, [t[sl].to(b.device)
                              for sl, b in zip(x.slices, x.blocks)])


def block_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-block tensors of one shape summed on the first block's device in
    block order, ``((p0 + p1) + p2) + ...``: the order in which the
    reference's all-reduce on the CPU adds its devices' partials.  Every
    cross-block sum of a mesh run goes through here, so its order is fixed
    (no float atomics, no collective library); one block is returned as it
    is."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


# --------------------------------------------------------------------------- #
# Initializers (parameters stored in the config's dtype).
# --------------------------------------------------------------------------- #


class ShapeOnly:
    """A generator stand-in that draws nothing: initializers given it make
    tensors on the ``meta`` device (a ``torch.Generator`` cannot live
    there), so a whole-size parameter tree costs no memory."""

    device = torch.device("meta")


def draws(generator):
    """``generator`` as the ``generator=`` of a ``torch`` random call:
    ``None`` for a :class:`ShapeOnly` one (meta tensors hold no values)."""
    return None if isinstance(generator, ShapeOnly) else generator


def _normal(shape, generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=draws(generator),
                       device=generator.device, dtype=_F32)


def dense_init(generator, in_dim: int, out_shape: Sequence[int],
               dtype) -> torch.Tensor:
    scale = in_dim ** -0.5
    return (_normal((in_dim, *out_shape), generator) * scale).to(dtype)


def embed_init(generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (_normal((vocab, d), generator) * 0.02).to(dtype)


def scaled_normal(generator, shape, scale: float, dtype) -> torch.Tensor:
    return (_normal(shape, generator) * scale).to(dtype)


def zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape, dtype, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# Norms and activations.
# --------------------------------------------------------------------------- #


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(_F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(_F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * scale + bias


def norm_init(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": ones((d,), dtype, device)}
    return {"scale": ones((d,), dtype, device),
            "bias": zeros((d,), dtype, device)}


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def activate(kind: str, x: torch.Tensor) -> torch.Tensor:
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default."""
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    if kind == "silu":
        return F.silu(x)
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# Rotary position embeddings.
# --------------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=_F32, device=device) / head_dim
    # a python base: no host-to-device copy (f32 pow, as the reference's)
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Computed in
    f32 and cast back to ``x``'s dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].to(_F32) * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                           # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., : hd // 2].to(_F32)
    x2 = x[..., hd // 2:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
