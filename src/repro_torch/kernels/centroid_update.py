"""Weighted-average k-means centroid adaptation (paper §4.3).

Replaces the Pallas TPU kernel
``repro/kernels/centroid_update.py:centroid_update`` (a one-hot matmul):

    c_j <- (w * c_j + sum_{i: a_i = j} x_i) / (w + n_j)

Rows whose assignment is ``< 0`` (or ``>= k``) are ignored, so the fleet
caller (``kmeans.online_update``) needs no one-hot.

The reference's arithmetic, read off its compiled program on the CPU
(``ops.fleet_centroid_update`` pads the rows to a multiple of 8 and runs
the kernel body as one XLA program):

* ``w * c_j + sum`` is one fused multiply-add (one rounding);
* the one-hot matmul sums a cluster's rows in :func:`row_blocks`' order:
  the padded rows split into ``P = ceil(N / 608)`` parts of
  ``8 * ceil(N / 8P)`` rows (the last part takes the rest), a part longer
  than 384 rows splits into two halves, each block sums its rows in row
  order from zero, and the block sums are added in order.  Found by
  probing the reference's summation tree at every multiple of 8 up to
  2,048 rows with ``k = 2`` and ``4`` clusters and ``F <= 128`` features;
  there it is bit-exact.  Once ``B * k`` passes about 8,900 (on 8 CPUs;
  about 16,000 on 2), the reference reduces in a threaded tree that
  depends on the CPUs the process may use; on one CPU it keeps this order
  (``tools/centroid_order_gap.py``; ROADMAP Queue 3).

The CUDA kernel (``csrc/centroid_update.cu``) runs one thread per
(cluster, column) and forms the same blocks in the same order — a
deterministic reduction, no float atomics; the plain version below is the
same arithmetic, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..core._fma import fma_f32
from . import _build

#: launches of the CUDA kernel (the plain version never counts)
launches = 0

#: rows per part of the reference's split, and the longest unsplit block
PART_ROWS = 608
BLOCK_ROWS = 384


def row_blocks(n_rows: int) -> list[tuple[int, int]]:
    """``(start, end)`` of the blocks the reference sums a cluster's rows
    in, for ``n_rows`` rows padded to a multiple of 8."""
    n8 = -(-n_rows // 8) * 8
    if n8 == 0:
        return []
    n_parts = -(-n8 // PART_ROWS)
    part = 8 * -(-n8 // (8 * n_parts))
    sizes = [part] * (n_parts - 1) + [n8 - (n_parts - 1) * part]
    out, start = [], 0
    for s in sizes:
        for b in ((s // 2, s // 2) if s > BLOCK_ROWS else (s,)):
            out.append((start, start + b))
            start += b
    return out


def centroid_update_plain(centroids, x, assign, weight):
    """The plain PyTorch version (same arithmetic, same order)."""
    k, B = centroids.shape[0], x.shape[0]
    hot = assign[:, None].to(torch.int64) == torch.arange(
        k, device=assign.device)                              # (B, k)
    sums = torch.zeros_like(centroids)
    for start, end in row_blocks(B):
        acc = torch.zeros_like(centroids)
        for b in range(start, min(end, B)):   # rows >= B are the padding
            acc = torch.where(hot[b][:, None], acc + x[b], acc)
        sums = sums + acc
    counts = hot.sum(0).to(torch.float32)[:, None]
    w = torch.full((), weight, dtype=torch.float32, device=centroids.device)
    return fma_f32(w, centroids, sums) / (w + counts)


def _check(centroids, x, assign):
    if centroids.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("centroid_update takes float32 centroids and x")
    if assign.dtype != torch.int32:
        raise TypeError("centroid_update takes int32 assignments")
    if (centroids.dim() != 2 or x.dim() != 2 or assign.dim() != 1
            or x.shape[1] != centroids.shape[1]
            or assign.shape[0] != x.shape[0]):
        raise ValueError(
            f"centroid_update: centroids (k, d), x (B, d), assign (B,); got "
            f"{tuple(centroids.shape)}, {tuple(x.shape)}, "
            f"{tuple(assign.shape)}")
    if not (centroids.device == x.device == assign.device):
        raise ValueError("centroid_update: inputs on different devices")


def centroid_update(centroids: torch.Tensor, x: torch.Tensor,
                    assign: torch.Tensor, weight: float) -> torch.Tensor:
    """``centroids`` ``(k, d)`` f32, ``x`` ``(B, d)`` f32, ``assign``
    ``(B,)`` int32, python ``weight`` (rounded to f32) -> new ``(k, d)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (contiguous inputs only)."""
    global launches
    _check(centroids, x, assign)
    if centroids.device.type == "cpu":
        return centroid_update_plain(centroids, x, assign, weight)
    if centroids.device.type != "cuda":
        raise ValueError(f"centroid_update: unsupported device "
                         f"{centroids.device}")
    if not (centroids.is_contiguous() and x.is_contiguous()
            and assign.is_contiguous()):
        raise ValueError("centroid_update: the kernel takes contiguous "
                         "tensors")
    k, d = centroids.shape
    out = torch.empty_like(centroids)
    if k * d == 0:
        return out
    lib = _build.load("centroid_update")
    fn = lib.centroid_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(centroids.data_ptr(), x.data_ptr(), assign.data_ptr(),
             x.shape[0], k, d, float(weight), out.data_ptr(),
             _build.stream_handle(centroids.device))
    _build.check(err, "centroid_update")
    launches += 1
    return out
