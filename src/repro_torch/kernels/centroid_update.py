"""Weighted-average k-means centroid adaptation (paper §4.3).

Replaces the Pallas TPU kernel
``repro/kernels/centroid_update.py:centroid_update`` (a one-hot matmul):

    c_j <- (w * c_j + sum_{i: a_i = j} x_i) / (w + n_j)

Rows whose assignment is ``< 0`` (or ``>= k``) are ignored, so the fleet
caller (``kmeans.online_update``) needs no one-hot.  The CUDA kernel
(``csrc/centroid_update.cu``) runs one thread per (cluster, column) and sums
the assigned rows in row order — a deterministic reduction, no float
atomics; the plain version sums in the same order, so the two agree bit for
bit.  Against the JAX package the result is bit-equal wherever each cluster
receives at most one row (the serve path's case); with more rows the
reference's matmul may sum in another order.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel (the plain version never counts)
launches = 0


def centroid_update_plain(centroids, x, assign, weight):
    """The plain PyTorch version (same arithmetic, same row order)."""
    k = centroids.shape[0]
    hot = assign[:, None].to(torch.int64) == torch.arange(
        k, device=assign.device)                              # (B, k)
    sums = torch.zeros_like(centroids)
    for b in range(x.shape[0]):
        sums = torch.where(hot[b][:, None], sums + x[b], sums)
    counts = hot.sum(0).to(torch.float32)[:, None]
    w = torch.full((), weight, dtype=torch.float32, device=centroids.device)
    return (w * centroids + sums) / (w + counts)


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
