"""L1 distance to k centroids + top-2 (the k-means classify inner loop).

Replaces the Pallas TPU kernel ``repro/kernels/l1_topk2.py:l1_topk2``.
For each row: the L1 distance to every centroid, the smallest (``d1``), its
first index (``idx``) and the second smallest (``d2``, the reference's
``1e30`` mask at ``idx``).  The CUDA kernel (``csrc/l1_topk2.cu``) sums
every window of the reference's order as its own chain, one block per row
(:func:`window_plan`); what bounds it and why it is laid out so is noted
there.

The centroids are one ``(k, d)`` set shared by every row (``kmeans.classify``)
or one set per row, ``(B, k, d)`` (the serve scan classifies each device's
completing unit against that device's bank).

Summation order: :func:`ordered_sum` — the reference's order on the CPU
(windows of 32, see ``csrc/l1_topk2.cuh``).  The plain version and the
kernel both take it, so they agree bit for bit, and both agree bit for bit
with the JAX package on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _cost

POS = 1e30
_WIN = 32
_MAX_D = _WIN ** 4     # the kernels track at most 3 window levels

#: launches of the CUDA kernel (the plain version never counts)
launches = 0


def ordered_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the fixed order of ``csrc/l1_topk2.cuh``:
    zero-pad to a multiple of 32 (half in front), sum each window of 32
    sequentially, recurse on the window sums; at most 32 terms are summed
    sequentially.  Every add is one f32 rounding."""
    n = a.shape[-1]
    if n <= _WIN:
        acc = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
        for j in range(n):
            acc = acc + a[..., j]
        return acc
    pad = (-n) % _WIN
    lo = pad // 2
    a = torch.nn.functional.pad(a, (lo, pad - lo))
    a = a.reshape(a.shape[:-1] + (a.shape[-1] // _WIN, _WIN))
    acc = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for j in range(_WIN):
        acc = acc + a[..., j]
    return ordered_sum(acc)


def l1_topk2_plain(x: torch.Tensor, centroids: torch.Tensor):
    """The plain PyTorch version (same arithmetic, same order)."""
    c = centroids if centroids.dim() == 3 else centroids[None]
    dist = ordered_sum(torch.abs(x[:, None, :] - c))          # (B, k)
    d1 = dist.amin(dim=-1)
    idx = torch.argmin(dist, dim=-1).to(torch.int32)
    iota = torch.arange(dist.shape[-1], device=dist.device)
    masked = torch.where(iota == idx[:, None].to(iota.dtype),
                         torch.full_like(dist, POS), dist)
    d2 = masked.amin(dim=-1)
    return d1, d2, idx


def _check(x, centroids):
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError("l1_topk2 takes float32 x and centroids")
    if x.dim() != 2 or centroids.dim() not in (2, 3):
        raise ValueError(f"l1_topk2: x must be (B, d) and centroids (k, d) "
                         f"or (B, k, d); got {tuple(x.shape)} and "
                         f"{tuple(centroids.shape)}")
    B, d = x.shape
    if centroids.shape[-1] != d or (centroids.dim() == 3
                                    and centroids.shape[0] != B):
        raise ValueError(f"l1_topk2: centroids {tuple(centroids.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if centroids.shape[-2] < 1:
        raise ValueError("l1_topk2 needs at least one centroid")
    if x.device != centroids.device:
        raise ValueError("l1_topk2: x and centroids on different devices")


def window_plan(d: int) -> tuple:
    """The levels of :func:`ordered_sum`'s order over ``d`` terms, as the
    kernel takes them: ``(nwin, lo0, lo1, lo2, n1, n2)``.  ``nwin`` windowed
    levels (0: ``d <= 32``, summed as one window), ``lo<l>`` the front
    padding of level ``l``, ``n<l>`` its number of elements (``n1``: the
    windows of level 0; ``n2``: of level 1)."""
    lo, n, m = [0, 0, 0], [d, 1, 1], d
    nwin = 0
    while m > _WIN and nwin < 3:
        pad = (-m) % _WIN
        lo[nwin] = pad // 2
        m = (m + pad) // _WIN
        nwin += 1
        if nwin < 3:
            n[nwin] = m
    return (nwin, lo[0], lo[1], lo[2], n[1], n[2])


@functools.lru_cache(maxsize=None)
def _plan_arg(d: int):
    """:func:`window_plan` as the kernel's ``int[6]`` argument."""
    return (ctypes.c_int * 6)(*window_plan(d))


_FN = {}


def _kernel():
    """The launch function of the built library, bound once."""
    fn = _FN.get("launch")
    if fn is None:
        fn = _build.load("l1_topk2").l1_topk2_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["launch"] = fn
    return fn


def work(B: int, k: int, d: int, per_row: bool = False) -> _cost.Work:
    """One call: x and the centroids (``(B, k, d)`` with ``per_row``,
    else ``(k, d)``) read once, d1, d2 and the index written (12 bytes a
    row); 3 operations (difference, absolute value, sum) per element of
    each of the ``B x k`` distances."""
    return _cost.Work(bytes=4 * (B * d + (B if per_row else 1) * k * d)
                      + 12 * B, ops=3.0 * B * k * d)


def _call_work(x, centroids, *, result):
    return work(x.shape[0], centroids.shape[-2], x.shape[1],
                centroids.dim() == 3)


@_cost.counted("l1_topk2", _call_work)
def l1_topk2(x: torch.Tensor, centroids: torch.Tensor):
    """``x`` ``(B, d)``, ``centroids`` ``(k, d)`` or ``(B, k, d)``, float32
    -> ``(d1 (B,) f32, d2 (B,) f32, idx (B,) int32)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (contiguous inputs only)."""
    global launches
    _check(x, centroids)
    if x.device.type == "cpu":
        return l1_topk2_plain(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"l1_topk2: unsupported device {x.device}")
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("l1_topk2: the kernel takes contiguous tensors")
    B, d = x.shape
    if d > _MAX_D:
        raise ValueError(f"l1_topk2: d={d} exceeds the kernel's {_MAX_D}")
    d1 = torch.empty(B, dtype=torch.float32, device=x.device)
    d2 = torch.empty_like(d1)
    idx = torch.empty(B, dtype=torch.int32, device=x.device)
    if B == 0:
        return d1, d2, idx
    err = _kernel()(x.data_ptr(), centroids.data_ptr(), B, d,
                    centroids.shape[-2], int(centroids.dim() == 3),
                    _plan_arg(d), d1.data_ptr(), d2.data_ptr(),
                    idx.data_ptr(), _build.stream_handle(x.device))
    _build.check(err, "l1_topk2")
    launches += 1
    return d1, d2, idx
