"""Diagonal linear recurrence of the RG-LRU (kernel I).

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py:rglru_scan``:
``a``, ``b`` ``(B, S, W)`` and ``h0`` ``(B, W)`` -> ``(h (B, S, W),
h_last (B, W))`` in f32 with ``h_t = a_t * h_{t-1} + b_t``.  The reference
kernel and its oracle (``kernels/ref.py:rglru_scan_ref``) both form ``a * h
+ b`` as one fused multiply-add on the CPU, so both versions here do too:
:func:`rglru_scan_plain` with :func:`repro_torch.core._fma.fma_f32`, the
CUDA kernel (``csrc/rglru_scan.cu``) with ``__fmaf_rn``.  They agree bit
for bit, and the plain version agrees bit for bit with the JAX kernel.
The reference pads the sequence with identity steps (``a = 1``, ``b =
0``); the kernel bounds-checks instead, which changes no bit.

The kernel runs one warp per lane tile of :data:`LANES` lanes of one batch
row and feeds it ``a`` and ``b`` through a ring of tiles of
:data:`STEP_TILE` steps in shared memory, filled by TMA or by ``cp.async``
(:func:`copy_path`); :func:`tile_plan` lists the tiles.

Training (:class:`_RGLRUScan`): under autograd, with an input that requires
a gradient, a CUDA call saves ``a``, ``h0`` and ``h`` and its backward
launches ``csrc/rglru_scan_bwd.cu`` (:func:`rglru_scan_bwd`, on the
forward's ring of stage tiles walked from the end: :func:`bwd_tile_plan`):
the recurrence in reverse, ``g_t = a_{t+1} g_{t+1} + dh_t`` (the product
and the sum rounded apart, as the reference's ``jax.vjp`` of its scan
rounds them), ``db = g``, ``da_t = g_t h_{t-1}``, ``dh0 = a_0 g_0``,
bit-equal to :func:`rglru_scan_bwd_plain` and to the reference.  Without
autograd the call launches exactly the forward it launches for serving.

The model's own path (:func:`repro_torch.models.rglru.rglru_seq`) launches
this kernel for a CUDA tensor; a CPU tensor there runs the port of the
reference's associative scan.

A ``meta`` tensor takes the card's route (through :class:`_RGLRUScan`
under autograd) and gets empty ``meta`` outputs, with no launch counted;
the op counter counts each call as one item of :func:`work` (or
:func:`bwd_work`).
"""
from __future__ import annotations

import ctypes

import torch

from ..core._fma import fma_f32
from . import _build, _cost

#: launches of the CUDA kernel (the plain version never counts)
launches = 0
#: launches of the backward kernel
bwd_launches = 0

#: lanes per block (one warp) and steps per stage tile, as
#: ``csrc/rglru_scan.cu`` has them (``LANES``, ``TS``)
LANES = 32
STEP_TILE = 32


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor):
    """The plain PyTorch version: a loop over ``S`` with one rounding per
    step."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    h = h0.to(torch.float32)
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = fma_f32(a[:, t], h, b[:, t])
        out[:, t] = h
    return out, h


def work(B: int, S: int, W: int) -> _cost.Work:
    """One forward call: a, b (f32) and h0 read once, h written once;
    one fused multiply-add (two flops) per element."""
    return _cost.Work(bytes=4 * (3 * B * S * W + B * W), ops=2.0 * B * S * W)


def bwd_work(B: int, S: int, W: int) -> _cost.Work:
    """One backward call: a, h, dh and h0 read once, da, db and dh0
    written once; two flops per element."""
    return _cost.Work(bytes=4 * (5 * B * S * W + 2 * B * W),
                      ops=2.0 * B * S * W)


def _call_work(a, b, h0, *, result):
    return work(*a.shape)


def _bwd_call_work(a, h0, h, dh, *, result):
    return bwd_work(*a.shape)


def copy_path(W: int, *ptrs: int) -> str:
    """How the kernel's ring is filled: ``"tma"`` (3-D TMA tiles) where
    every row of a ``(B, S, W)`` f32 tensor starts on 16 bytes, i.e.
    ``W % 4 == 0`` and every pointer is 16-byte aligned; else
    ``"cp.async"`` (one 4-byte copy per lane and step)."""
    if W % 4 == 0 and all(p % 16 == 0 for p in ptrs):
        return "tma"
    return "cp.async"


def tile_plan(S: int, W: int):
    """``(step tiles, lane tiles)``: the ``(start, end)`` ranges of ``S``
    and ``W`` the kernel scans, one block per (row, lane tile), each
    walking its step tiles in order; ragged last tiles are cut at ``S``
    and ``W``."""
    steps = [(t, min(t + STEP_TILE, S)) for t in range(0, S, STEP_TILE)]
    lanes = [(w, min(w + LANES, W)) for w in range(0, W, LANES)]
    return steps, lanes


def bwd_tile_plan(S: int, W: int):
    """``(step tiles, lane tiles)`` of the backward kernel: the ``(start,
    end)`` ranges of ``S`` in the order each block walks them, from the end
    of the sequence (the forward's step tiles reversed, the ragged one
    first), and the lane tiles of :func:`tile_plan`.  A tile's h is staged
    one step behind (``start - 1 .. end - 2``), so its first step's
    ``h_{t-1}`` is in the same stage, ``h0`` at ``t = 0``."""
    steps, lanes = tile_plan(S, W)
    return steps[::-1], lanes


def _check(a, b, h0):
    if a.dim() != 3 or a.shape != b.shape or h0.shape != (a.shape[0],
                                                           a.shape[2]):
        raise ValueError(f"rglru_scan: a, b (B, S, W) and h0 (B, W); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if not (a.device == b.device == h0.device):
        raise ValueError("rglru_scan: inputs on different devices")


_FN = {}


def _kernel():
    """``rglru_scan_launch``, bound once."""
    fn = _FN.get("launch")
    if fn is None:
        fn = _build.load("rglru_scan").rglru_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _FN["launch"] = fn
    return fn


def _launch(a, b, h0):
    """Kernel I on CUDA tensors: ``h`` (B, S, W) f32; on ``meta``
    tensors the empty output, nothing launched."""
    global launches
    B, S, W = a.shape
    a, b, h0 = (t.to(torch.float32).contiguous() for t in (a, b, h0))
    h = torch.empty_like(a)
    if h.numel() == 0 or a.device.type == "meta":
        return h
    tma = copy_path(W, a.data_ptr(), b.data_ptr(), h.data_ptr()) == "tma"
    err = _kernel()(a.data_ptr(), b.data_ptr(), h0.data_ptr(), B, S, W,
                    int(tma), h.data_ptr(), _build.stream_handle(a.device))
    _build.check(err, "rglru_scan")
    launches += 1
    return h


class _RGLRUScan(torch.autograd.Function):
    """Kernel I with its gradient (:func:`rglru_scan_bwd`)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _launch(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h0, h, dh)


@_cost.counted("rglru_scan", _call_work)
def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """``(h (B, S, W), h_last (B, W))`` f32.  A CPU tensor takes the plain
    version (differentiable by autograd); a CUDA tensor launches the kernel
    (inputs cast to f32 and made contiguous), through
    :class:`_RGLRUScan` when autograd needs a gradient of an input, and
    ``h_last`` is then the view ``h[:, -1]``.  A ``meta`` tensor takes the
    CUDA route and launches nothing."""
    _check(a, b, h0)
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan: unsupported device {dev}")
    if a.shape[1] == 0:
        return torch.empty_like(a, dtype=torch.float32), h0.to(
            torch.float32).clone()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        h = _RGLRUScan.apply(a.to(torch.float32), b.to(torch.float32),
                             h0.to(torch.float32))
    else:
        h = _launch(a, b, h0)
    return h, h[:, -1]


# --------------------------------------------------------------------------- #
# The backward.
# --------------------------------------------------------------------------- #


def rglru_scan_bwd_plain(a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor,
                         dh: torch.Tensor):
    """The plain PyTorch version of the backward: a reverse loop over
    ``S`` with the kernel's roundings (``g = a_{t+1} * g + dh_t``, product
    and sum each rounded, then ``da_t = g * h_{t-1}``).  Returns ``(da,
    db, dh0)`` f32."""
    a, h0, h, dh = (t.to(torch.float32) for t in (a, h0, h, dh))
    S = a.shape[1]
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = torch.zeros_like(h0)
    a_next = torch.zeros_like(h0)
    for t in range(S - 1, -1, -1):
        g = a_next * g + dh[:, t]
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else h0)
        a_next = a[:, t]
    return da, db, a_next * g


_BWD = {}


def _bwd_kernel():
    """``rglru_scan_bwd_launch``, bound once."""
    fn = _BWD.get("launch")
    if fn is None:
        fn = _build.load("rglru_scan_bwd").rglru_scan_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _BWD["launch"] = fn
    return fn


@_cost.counted("rglru_scan_bwd", _bwd_call_work)
def rglru_scan_bwd(a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor):
    """``(da, db, dh0)`` f32 of the recurrence from the forward's ``a``,
    ``h0`` and ``h`` and the cotangent ``dh`` of ``h``.  A CPU tensor takes
    the plain version; a CUDA tensor launches ``csrc/rglru_scan_bwd.cu``
    (its ring filled as :func:`copy_path` says, the tiles of
    :func:`bwd_tile_plan`); a ``meta`` tensor gets empty gradients."""
    global bwd_launches
    if a.device.type == "cpu":
        return rglru_scan_bwd_plain(a, h0, h, dh)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan_bwd: unsupported device {a.device}")
    B, S, W = a.shape
    a, h0, h, dh = (t.to(torch.float32).contiguous() for t in (a, h0, h, dh))
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if a.numel() == 0:
        return da, db, dh0.zero_()
    if a.device.type == "meta":
        return da, db, dh0
    tma = copy_path(W, a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                    da.data_ptr(), db.data_ptr()) == "tma"
    err = _bwd_kernel()(a.data_ptr(), h0.data_ptr(), h.data_ptr(),
                        dh.data_ptr(), B, S, W, int(tma), da.data_ptr(),
                        db.data_ptr(), dh0.data_ptr(),
                        _build.stream_handle(a.device))
    _build.check(err, "rglru_scan_bwd")
    bwd_launches += 1
    return da, db, dh0
