"""Roofline terms, useful work, collectives and memory of a step on the
H100 (port of :mod:`repro.launch.hlo_stats`).

The reference prices a compiled XLA program for its TPU; the port prices
the ops that PyTorch dispatches (:mod:`repro_torch.launch.op_cost`)
for one NVIDIA H100 SXM at NVIDIA's data-sheet peaks (dense, no
sparsity, at the card's full 700 W): 989 TFLOP/s of bf16 on the tensor
cores, 67 TFLOP/s of f32 on the CUDA cores, 3.35 TB/s of HBM and 450 GB/s
of NVLink per direction.  The port turns TF32 off, so f32 products, like
every other op, run at the f32 peak; only bf16 (and f16) products run at
the tensor-core peak.

Collectives are the ``_c10d_functional`` ops of the op record, priced with
the reference's ring factors (``G`` the group size):

    all_gather_into_tensor   out_bytes * (G-1)/G
    reduce_scatter_tensor    out_bytes * (G-1)
    all_reduce               2 * bytes * (G-1)/G
    all_to_all_single        bytes * (G-1)/G

The port's steps issue none today, so the collective term is 0.

:func:`memory_record` is the counterpart of ``memory_analysis_dict``: one
device's argument and output bytes under the spec tables of
:mod:`repro_torch.launch.sharding`; the temporaries need an allocator, so
on ``meta`` they are ``None``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sharding as shd

#: NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, f32 on the
#: CUDA cores, HBM bandwidth, NVLink bandwidth per direction
PEAK_BF16_S = 989e12
PEAK_F32_S = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

#: dtypes whose products run on the tensor cores at :data:`PEAK_BF16_S`
TENSOR_CORE_TYPES = ("bf16", "f16")


def peak_of(dtype: str) -> float:
    """FLOP/s of products of ``dtype`` (a short name: ``"bf16"``,
    ``"f32"``, ...)."""
    return PEAK_BF16_S if dtype in TENSOR_CORE_TYPES else PEAK_F32_S


def roofline_terms(*, flops: float, bytes_accessed: float, ici_bytes: float,
                   tc_flops: float = 0.0) -> dict:
    """Three per-device roofline terms (seconds) and the dominant one.

    ``tc_flops`` is the part of ``flops`` on the tensor cores (bf16
    products); the rest runs at the f32 peak.  ``ici_bytes`` (the
    reference's name) are the collectives' bytes over NVLink."""
    compute_s = tc_flops / PEAK_BF16_S + (flops - tc_flops) / PEAK_F32_S
    memory_s = bytes_accessed / HBM_BW
    collective_s = ici_bytes / NVLINK_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant.replace("_s", "")
    total = max(compute_s, memory_s, collective_s)
    terms["bound_s"] = total
    terms["compute_fraction_of_bound"] = compute_s / total if total else 0.0
    return terms


def kernel_bound(work) -> tuple[float, str]:
    """``(seconds, "bytes" or "operations")``: one kernel call's least
    time, the larger of its bytes over HBM bandwidth and its operations
    over the peak of their type (``work`` a
    :class:`repro_torch.kernels._cost.Work`)."""
    t_b, t_o = work.bytes / HBM_BW, work.ops / peak_of(work.dtype)
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def model_flops(cfg, step_kind: str, global_batch: int,
                seq_len: int) -> float:
    """Useful-work estimate: 6·N_active·D (train) / 2·N_active·D (inference);
    D = tokens processed (decode: one token per sequence)."""
    n = cfg.active_param_count()
    mult = 6.0 if step_kind == "train" else 2.0
    tokens = global_batch * (seq_len if step_kind != "decode" else 1)
    return mult * n * tokens


# --------------------------------------------------------------------------- #
# Collectives.
# --------------------------------------------------------------------------- #

#: ``_c10d_functional`` op name -> the reference's collective kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def ring_bytes(kind: str, size: float, group: int) -> float:
    """Bytes one device moves for a collective of ``size`` result bytes
    over a group of ``group`` devices (the ring model)."""
    G = max(int(group), 1)
    if kind == "all-gather":
        return size * (G - 1) / G
    if kind == "reduce-scatter":
        return size * (G - 1)
    if kind == "all-reduce":
        return 2.0 * size * (G - 1) / G
    if kind == "all-to-all":
        return size * (G - 1) / G
    return float(size)          # a permute


class CollectiveStats:
    """The collectives of an op record: ring bytes per device, raw result
    bytes, counts and bytes by kind."""

    def __init__(self):
        self.ici_bytes = 0.0
        self.raw_bytes = 0.0
        self.counts: dict = {}
        self.by_kind_bytes: dict = {}

    def add(self, kind: str, size: float, group: int) -> float:
        moved = ring_bytes(kind, size, group)
        self.ici_bytes += moved
        self.raw_bytes += size
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.by_kind_bytes[kind] = self.by_kind_bytes.get(kind, 0.0) + moved
        return moved

    def as_dict(self) -> dict:
        return {
            "ici_bytes": self.ici_bytes,
            "raw_bytes": self.raw_bytes,
            "counts": self.counts,
            "by_kind_bytes": self.by_kind_bytes,
        }


def collective_stats(ops, n_devices: int = 1) -> CollectiveStats:
    """Collectives of ``ops``, the op record's ``(op name, result bytes,
    group size)`` rows (``Cost.collectives`` of
    :mod:`repro_torch.launch.op_cost`); a row without a group spans
    ``n_devices``, a row of another op is skipped."""
    st = CollectiveStats()
    for name, size, group in ops:
        kind = COLLECTIVES.get(name.split(".")[-1])
        if kind is not None:
            st.add(kind, size, group or n_devices)
    return st


# --------------------------------------------------------------------------- #
# Memory.
# --------------------------------------------------------------------------- #


def shard_shape(mesh, spec, shape) -> tuple:
    """One device's block of a leaf of ``shape`` under ``spec``."""
    sizes = mesh.shape
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        out[i] //= int(np.prod([sizes[a] for a in axes], dtype=np.int64))
    return tuple(out)


def shard_bytes(mesh, tree, specs) -> int:
    """One device's bytes of ``tree`` under the spec tree ``specs``."""
    total = 0
    for leaf, spec in zip(shd._leaves(tree), _spec_leaves(specs)):
        total += (int(np.prod(shard_shape(mesh, spec, leaf.shape),
                              dtype=np.int64)) * leaf.dtype.itemsize)
    return total


def _spec_leaves(specs) -> list:
    out = []
    shd._map(out.append, specs, is_leaf=lambda s: isinstance(s, shd.P))
    return out


def _replicated(tree):
    return shd._map(lambda leaf: shd.P(), tree)


def step_specs(spec, mesh, params, opt_state=None, outputs=None):
    """The spec trees of a step's arguments and outputs, as the
    reference's ``lower_step`` shards them: ``(args, arg specs, outputs,
    output specs)``; the outputs are ``None`` when not given."""
    psp = shd.param_specs(mesh, params)
    if spec.step_kind == "train":
        (batch,) = spec.args
        args = (params, opt_state, batch)
        arg_specs = (psp, shd.param_specs(mesh, opt_state),
                     shd.batch_specs(mesh, batch))
        out_specs = None
        if outputs is not None:
            out_specs = (arg_specs[0], arg_specs[1], _replicated(outputs[2]))
    elif spec.step_kind == "prefill":
        (batch,) = spec.args
        args, arg_specs = (params, batch), (psp, shd.batch_specs(mesh, batch))
        out_specs = None
        if outputs is not None:
            logits, state = outputs
            out_specs = (shd.logits_spec(mesh, *logits.shape, ndim=2),
                         shd.state_specs(mesh, state))
    else:
        state, token = spec.args
        args = (params, state, token)
        arg_specs = (psp, shd.state_specs(mesh, state),
                     shd.batch_specs(mesh, token))
        out_specs = None
        if outputs is not None:
            logits, new_state = outputs
            out_specs = (shd.logits_spec(mesh, *logits.shape, ndim=2),
                         shd.state_specs(mesh, new_state))
    return args, arg_specs, outputs, out_specs


def memory_record(spec, mesh, params, opt_state=None, outputs=None,
                  temp_bytes=None) -> dict:
    """One device's ``argument_size_in_bytes`` and
    ``output_size_in_bytes`` of the step ``spec`` dictates on ``mesh``
    (the outputs' when given), and ``temp_size_in_bytes``: ``temp_bytes``
    (the peak above the arguments on a card), ``None`` on ``meta``."""
    args, arg_specs, outputs, out_specs = step_specs(
        spec, mesh, params, opt_state, outputs)
    rec = {"argument_size_in_bytes": shard_bytes(mesh, args, arg_specs)}
    if outputs is not None:
        rec["output_size_in_bytes"] = shard_bytes(mesh, outputs, out_specs)
    rec["temp_size_in_bytes"] = temp_bytes
    return rec


def dtype_name(dtype: torch.dtype) -> str:
    """The short name of a dtype: ``"bf16"``, ``"f32"``, ``"s32"``, ..."""
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


_DTYPE_NAMES = {
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}
