"""Op-level cost model: FLOPs, HBM bytes and collective bytes of everything
a call dispatches (port of :mod:`repro.launch.hlo_cost`).

The reference re-derives a compiled XLA program's costs from its HLO text,
multiplying loop bodies by their trip counts.  Eager PyTorch has no
program: :class:`Counter` is a ``TorchDispatchMode`` that sees every ATen
op a call dispatches, the backward included (autograd runs the backward
under the same mode, on the card on its device thread too), so loops need
no trip counts: the counter sees every iteration.  It works on any device,
``meta`` included, where nothing is computed.

Conventions:

* Views and aliases (``view``, ``reshape`` without a copy, ``transpose``,
  ``expand``, slicing, ``detach``), allocations (``empty``) and host reads
  of a scalar cost nothing.
* Products and convolutions, their backward ops too, count ``2·M·N·K``
  (the formulas of ``torch.utils.flop_counter``), in ``dot_flops`` and in
  ``dot_flops_by_dtype`` under the output's type; bf16 and f16 products
  run on the tensor cores.
* Elementwise ops count one flop per output element; reductions one per
  operand element; data movement (copies, casts, fills, concatenation,
  gathers and scatters) none.
* Bytes are each op's operands plus its outputs, except that a copy
  reads only its source, a fill writes only its output, a gather moves its
  rows (twice its output) and its indices, and a scatter its updates
  (twice) and indices.  Unlike the reference's TPU convention
  (``hlo_cost.py:51-58``), copies and casts count here: in eager PyTorch
  each one is a launch of its own that reads and writes HBM.
* A kernel of :mod:`repro_torch.kernels` counts as one item of its
  ``work()`` (:mod:`repro_torch.kernels._cost`), the ops inside its
  wrapper (or its plain version on the CPU, or its ``meta`` branch)
  uncounted.  On the CPU under autograd the plain versions of G and I
  are differentiated by autograd, so their backward counts as its ops.
* Collectives are the ``_c10d_functional`` ops, priced by
  :func:`repro_torch.launch.op_stats.collective_stats` (the reference's
  ring factors); the port issues none today.

What the counter cannot see: work replayed from a CUDA graph bypasses the
dispatcher (the serve scan's ``_GraphedSteps`` in
:mod:`repro_torch.serve.fleet_engine`), so no graphed path is counted.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import _cost
from .op_stats import (COLLECTIVES, TENSOR_CORE_TYPES, collective_stats,
                       dtype_name)

#: ops that cost nothing besides the views (``OpOverload.is_view``)
_FREE = frozenset({
    "_unsafe_view", "lift_fresh", "_local_scalar_dense", "detach", "alias",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_reshape_alias", "resize_", "set_", "record_stream", "is_same_size",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "equal",
    "wait_tensor", "_wrap_tensor_autograd",
})
#: reductions: one flop per operand element
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
    "logsumexp", "any", "all", "count_nonzero", "nansum",
})
#: copies and casts: read the source, write the output
_COPIES = frozenset({"copy_", "_to_copy", "clone", "_copy_from",
                     "_copy_from_and_resize", "contiguous"})
#: fills and factories: write the output only
_FILLS = frozenset({"fill_", "zero_", "zeros", "ones", "full", "zeros_like",
                    "ones_like", "full_like", "new_zeros", "new_ones",
                    "new_full", "arange", "scalar_tensor", "linspace"})
#: concatenation and other pure data movement: operands and outputs
_MOVES = frozenset({"cat", "stack", "constant_pad_nd", "roll", "flip",
                    "repeat", "tril", "triu", "where", "masked_fill",
                    "masked_fill_", "one_hot", "sort", "topk"})
#: gathers: the rows they read (their output) and their indices
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "take", "take_along_dim"})
#: scatters: their updates (read and written) and their indices
_SCATTERS = frozenset({"index_put", "index_put_", "_index_put_impl_",
                       "scatter", "scatter_", "scatter_add", "scatter_add_",
                       "index_add", "index_add_", "index_copy",
                       "index_copy_", "embedding_dense_backward",
                       "select_scatter", "slice_scatter"})


def _tensors(tree) -> list:
    """The distinct tensors of ``tree`` (a tensor passed twice is read
    once)."""
    seen, out = set(), []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _type_str(outs) -> str:
    if not outs:
        return "()"
    t = outs[0]
    return f"{dtype_name(t.dtype)}[{','.join(map(str, t.shape))}]"


@dataclass
class Cost:
    """The reference's ``Cost`` with the products split by type and the
    counted items: ``items[(op, type)] = [calls, flops, bytes]``, the
    calls of each kernel in ``kernels`` and the collectives' ``(op,
    result bytes, group size)`` rows in ``collectives``, from which the
    ring-model ``ici_bytes``, ``coll_counts`` and ``coll_bytes`` are
    derived."""

    flops: float = 0.0           # total (products, elementwise, kernels)
    dot_flops: float = 0.0
    bytes: float = 0.0
    dot_flops_by_dtype: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    items: dict = field(default_factory=dict)
    collectives: list = field(default_factory=list)

    @property
    def ici_bytes(self) -> float:
        return collective_stats(self.collectives).ici_bytes

    @property
    def coll_counts(self) -> dict:
        return collective_stats(self.collectives).counts

    @property
    def coll_bytes(self) -> dict:
        return collective_stats(self.collectives).by_kind_bytes

    @property
    def tc_flops(self) -> float:
        """The products on the tensor cores (bf16, f16)."""
        return sum(self.dot_flops_by_dtype.get(t, 0.0)
                   for t in TENSOR_CORE_TYPES)

    def add_item(self, op: str, type_str: str, flops: float, nbytes: float,
                 dot_dtype: str | None = None) -> None:
        self.flops += flops
        self.bytes += nbytes
        if dot_dtype is not None:
            self.dot_flops += flops
            self.dot_flops_by_dtype[dot_dtype] = (
                self.dot_flops_by_dtype.get(dot_dtype, 0.0) + flops)
        row = self.items.get((op, type_str))
        if row is None:
            self.items[(op, type_str)] = [1, flops, nbytes]
        else:
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "dot_flops_by_dtype": dict(self.dot_flops_by_dtype),
            "bytes": self.bytes,
            "ici_bytes": self.ici_bytes,
            "coll_counts": self.coll_counts,
            "coll_bytes": self.coll_bytes,
            "kernels": dict(self.kernels),
        }


class Counter(TorchDispatchMode):
    """Counts what runs under it into :attr:`cost`; also the sink of the
    kernels' entry points (:mod:`repro_torch.kernels._cost`).  A
    collective over no explicit group spans ``n_devices``."""

    def __init__(self, n_devices: int = 1):
        super().__init__()
        self.cost = Cost()
        self.n_devices = n_devices
        #: > 0 inside a kernel's entry point: its ops are not counted
        self.mute = 0
        self._prev = None

    def __enter__(self):
        self._prev, _cost.sink = _cost.sink, self
        return super().__enter__()

    def __exit__(self, *exc):
        _cost.sink = self._prev
        return super().__exit__(*exc)

    def note(self, name: str, work: _cost.Work) -> None:
        """One call of kernel ``name`` doing ``work``."""
        self.cost.add_item(name, "kernel", work.ops, work.bytes,
                           work.dtype if work.dot else None)
        self.cost.kernels[name] = self.cost.kernels.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.mute:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return
        outs = _tensors(out)
        out_b = _cost.nbytes(*outs)
        ins = _tensors((args, kwargs))
        cost = self.cost
        flop_fn = flop_registry.get(func.overloadpacket)
        if flop_fn is not None:
            f = float(flop_fn(*args, **kwargs, out_val=out))
            cost.add_item(name, _type_str(outs), f,
                          _cost.nbytes(*ins) + out_b,
                          dtype_name(outs[0].dtype))
        elif name in COLLECTIVES:
            cost.collectives.append(
                (name, out_b, _group_size(args, kwargs) or self.n_devices))
            cost.add_item(name, _type_str(outs), 0.0,
                          _cost.nbytes(*ins) + out_b)
        elif name in _REDUCTIONS:
            cost.add_item(name, _type_str(outs), float(ins[0].numel()),
                          _cost.nbytes(*ins) + out_b)
        elif name in _COPIES:
            src = args[1] if name in ("copy_", "_copy_from",
                                      "_copy_from_and_resize") else args[0]
            cost.add_item(name, _type_str(outs), 0.0,
                          _cost.nbytes(src) + out_b)
        elif name in _FILLS:
            cost.add_item(name, _type_str(outs), 0.0, out_b)
        elif name in _GATHERS:
            idx = _cost.nbytes(*(t for t in ins[1:]
                                 if not t.dtype.is_floating_point))
            cost.add_item(name, _type_str(outs), 0.0, 2 * out_b + idx)
        elif name in _SCATTERS:
            upd = [t for t in ins[1:] if t.dtype.is_floating_point]
            idx = _cost.nbytes(*(t for t in ins[1:]
                                 if not t.dtype.is_floating_point))
            cost.add_item(name, _type_str(outs), 0.0,
                          2 * _cost.nbytes(*upd) + idx)
        elif name in _MOVES:
            cost.add_item(name, _type_str(outs), 0.0,
                          _cost.nbytes(*ins) + out_b)
        else:
            cost.add_item(name, _type_str(outs),
                          float(sum(t.numel() for t in outs)),
                          _cost.nbytes(*ins) + out_b)


def _group_size(args, kwargs) -> int:
    """The group size argument of a ``_c10d_functional`` op, if any."""
    g = kwargs.get("group_size")
    if g is None:
        ints = [a for a in args if isinstance(a, int)
                and not isinstance(a, bool)]
        g = ints[0] if ints else None
    return int(g) if g else 0


def count(fn, *args, n_devices: int = 1, **kwargs):
    """``(fn(*args, **kwargs), Cost)``: one call counted."""
    with Counter(n_devices) as c:
        out = fn(*args, **kwargs)
    return out, c.cost


def analyze(fn, *args, n_devices: int = 1, **kwargs) -> dict:
    """The reference's ``analyze_hlo`` keys (and the products by type and
    the kernel calls) of one call of ``fn``."""
    return count(fn, *args, n_devices=n_devices, **kwargs)[1].as_dict()


def top_cost_items(cost: Cost, n: int = 25, by: str = "bytes") -> list[dict]:
    """The ``n`` costliest items by ``by`` (``"bytes"`` or ``"flops"``):
    each op (or kernel) and output type, its calls as ``mult``."""
    items = [{"name": op, "op": op, "type": t, "mult": calls,
              "flops": flops, "bytes": nbytes}
             for (op, t), (calls, flops, nbytes) in cost.items.items()]
    items.sort(key=lambda r: -r[by])
    return items[:n]
