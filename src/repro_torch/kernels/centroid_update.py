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
  there it is bit-exact.  With one cluster (``k = 1``) the one-hot
  matmul is one sequential sum over all rows in row order (probed at
  392-4,096 rows, ``F`` 6 and 300).  Once ``B * k`` passes about 8,900
  (on 8 CPUs; about 16,000 on 2), the reference reduces in a threaded tree that
  depends on the CPUs the process may use; on one CPU it keeps this order
  (``tools/centroid_order_gap.py``; ROADMAP Queue 3).

The CUDA kernel (``csrc/centroid_update.cu``) makes one pass over the
assigned rows: one block per 32 columns sorts each chunk of
:data:`CHUNK_ROWS` rows by cluster (row order kept within a cluster), and
one warp per cluster walks its rows once, one lane per column, with one
running sum that takes each row block's sum at :func:`block_end` as the
reference adds its block sums — a deterministic reduction, no float
atomics; the plain version below is the same arithmetic, so the two
agree bit for bit.

Over a mesh the reference's partitioned program sums each block's rows
locally (the one-hot product over the block's rows, :func:`row_blocks` of
the block's count), adds the blocks' partial sums and f32 counts in block
order (its all-reduce on the CPU adds the devices' partials in device
order) and finishes ``(w c + sum) / (w + n)`` after that, read off the
dumped program of ``FleetServeEngine.run`` over a 4-device mesh.  So the
kernel has two more entries: :func:`centroid_partial` (one block's sums
and counts, the same walk) and :func:`centroid_finish` (the finish of the
summed partials).
"""
from __future__ import annotations

import ctypes

import torch

from ..core._fma import fma_f32
from . import _build, _cost

#: launches of the CUDA kernel's entries (the plain versions never count)
launches = 0
partial_launches = 0
finish_launches = 0

#: rows per part of the reference's split, and the longest unsplit block
PART_ROWS = 608
BLOCK_ROWS = 384
#: rows the kernel sorts per pass (``E_CHUNK``) and the most clusters its
#: shared memory holds (``E_MAX_K``), as ``csrc/centroid_update.cu`` has them
CHUNK_ROWS = 2048
MAX_K = 128


def row_blocks(n_rows: int, k: int) -> list[tuple[int, int]]:
    """``(start, end)`` of the blocks the reference sums a cluster's rows
    in, for ``n_rows`` rows padded to a multiple of 8 and ``k`` clusters
    (one block of all rows when ``k == 1``)."""
    n8 = -(-n_rows // 8) * 8
    if n8 == 0:
        return []
    if k == 1:
        return [(0, n8)]
    n_parts = -(-n8 // PART_ROWS)
    part = 8 * -(-n8 // (8 * n_parts))
    sizes = [part] * (n_parts - 1) + [n8 - (n_parts - 1) * part]
    out, start = [], 0
    for s in sizes:
        for b in ((s // 2, s // 2) if s > BLOCK_ROWS else (s,)):
            out.append((start, start + b))
            start += b
    return out


def block_end(row: int, n_rows: int, k: int) -> int:
    """The end of the :func:`row_blocks` block that holds ``row`` (of
    ``n_rows`` rows, ``k`` clusters), as the kernel computes it."""
    n8 = -(-n_rows // 8) * 8
    if k == 1:
        return n8
    n_parts = -(-n8 // PART_ROWS)
    part = 8 * -(-n8 // (8 * n_parts))
    p = min(row // part, n_parts - 1)
    start = p * part
    size = part if p + 1 < n_parts else n8 - start
    if size > BLOCK_ROWS:
        half = size // 2
        return start + half if row < start + half else start + size
    return start + size


def centroid_partial_plain(x, assign, k: int):
    """The plain version of :func:`centroid_partial`: ``(sums (k, d),
    counts (k,) f32)`` of ``x``'s rows per cluster, in the kernel's order."""
    B = x.shape[0]
    hot = assign[:, None].to(torch.int64) == torch.arange(
        k, device=assign.device)                              # (B, k)
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    for start, end in row_blocks(B, k):
        acc = torch.zeros_like(sums)
        for b in range(start, min(end, B)):   # rows >= B are the padding
            acc = torch.where(hot[b][:, None], acc + x[b], acc)
        sums = sums + acc
    return sums, hot.sum(0).to(torch.float32)


def centroid_finish_plain(centroids, sums, counts, weight):
    """The plain version of :func:`centroid_finish`."""
    w = torch.full((), weight, dtype=torch.float32, device=centroids.device)
    return fma_f32(w, centroids, sums) / (w + counts[:, None])


def centroid_update_plain(centroids, x, assign, weight):
    """The plain PyTorch version (same arithmetic, same order)."""
    sums, counts = centroid_partial_plain(x, assign, centroids.shape[0])
    return centroid_finish_plain(centroids, sums, counts, weight)


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


_FN = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "centroid_update_launch": [_P, _P, _P, _I, _I, _I, _F, _P, _P],
    "centroid_partial_launch": [_P, _P, _I, _I, _I, _P, _P, _P],
    "centroid_finish_launch": [_P, _P, _P, _I, _I, _F, _P, _P],
}


def _kernel(entry: str = "centroid_update_launch"):
    """An entry of the built library, bound once."""
    fn = _FN.get(entry)
    if fn is None:
        fn = getattr(_build.load("centroid_update"), entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _FN[entry] = fn
    return fn


def work(k: int, d: int, B: int, n_valid: int | None = None) -> _cost.Work:
    """One call: the ``n_valid`` assigned rows of x (every row when
    None) and the int32 assignments read once, the centroids read and
    written once; one add per assigned element and ~4 operations per
    centroid element (the weighted sum and the division)."""
    n_valid = B if n_valid is None else n_valid
    return _cost.Work(bytes=4 * n_valid * d + 8 * k * d + 4 * B,
                      ops=float(n_valid * d + 4 * k * d))


def _call_work(centroids, x, assign, weight, *, result):
    n_valid = (None if assign.device.type == "meta"
               else int((assign >= 0).sum()))
    return work(*centroids.shape, x.shape[0], n_valid)


@_cost.counted("centroid_update", _call_work)
def centroid_update(centroids: torch.Tensor, x: torch.Tensor,
                    assign: torch.Tensor, weight: float) -> torch.Tensor:
    """``centroids`` ``(k, d)`` f32, ``x`` ``(B, d)`` f32, ``assign``
    ``(B,)`` int32, python ``weight`` (rounded to f32) -> new ``(k, d)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (contiguous inputs, ``k <= MAX_K``)."""
    global launches
    _check(centroids, x, assign)
    dev = centroids.device
    if dev.type == "cpu":
        return centroid_update_plain(centroids, x, assign, weight)
    if dev.type != "cuda":
        raise ValueError(f"centroid_update: unsupported device {dev}")
    if not (centroids.is_contiguous() and x.is_contiguous()
            and assign.is_contiguous()):
        raise ValueError("centroid_update: the kernel takes contiguous "
                         "tensors")
    k, d = centroids.shape
    if k > MAX_K:
        raise ValueError(f"centroid_update: k={k} exceeds the kernel's "
                         f"{MAX_K} clusters")
    out = torch.empty_like(centroids)
    if k * d == 0:
        return out
    err = _kernel()(centroids.data_ptr(), x.data_ptr(), assign.data_ptr(),
                    x.shape[0], k, d, float(weight), out.data_ptr(),
                    _build.stream_handle(dev))
    _build.check(err, "centroid_update")
    launches += 1
    return out


def _cuda_ready(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return dev


def partial_work(k: int, d: int, B: int,
                 n_valid: int | None = None) -> _cost.Work:
    """One :func:`centroid_partial` call: the assigned rows and the
    assignments read once, the sums and counts written once; one add per
    assigned element."""
    n_valid = B if n_valid is None else n_valid
    return _cost.Work(bytes=4 * n_valid * d + 4 * B + 4 * k * (d + 1),
                      ops=float(n_valid * d))


def finish_work(k: int, d: int) -> _cost.Work:
    """One :func:`centroid_finish` call: centroids, sums and counts read,
    the new centroids written; ~4 operations per element."""
    return _cost.Work(bytes=4 * (3 * k * d + k), ops=4.0 * k * d)


def _partial_call_work(x, assign, k, *, result):
    n_valid = (None if assign.device.type == "meta"
               else int(((assign >= 0) & (assign < k)).sum()))
    return partial_work(k, x.shape[1], x.shape[0], n_valid)


@_cost.counted("centroid_partial", _partial_call_work)
def centroid_partial(x: torch.Tensor, assign: torch.Tensor, k: int):
    """One block's share of :func:`centroid_update`: ``x`` ``(B, d)`` f32
    and ``assign`` ``(B,)`` int32 -> ``(sums (k, d), counts (k,))`` f32,
    each cluster's rows summed in the kernel's order (rows outside ``[0,
    k)`` ignored).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel's partial entry."""
    global partial_launches
    if x.dtype != torch.float32 or assign.dtype != torch.int32:
        raise TypeError("centroid_partial takes float32 x and int32 "
                        "assignments")
    if x.dim() != 2 or assign.shape != (x.shape[0],):
        raise ValueError(f"centroid_partial: x (B, d), assign (B,); got "
                         f"{tuple(x.shape)}, {tuple(assign.shape)}")
    if x.device.type == "cpu":
        return centroid_partial_plain(x, assign, k)
    dev = _cuda_ready("centroid_partial", x, assign)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"centroid_partial: k={k} outside [1, {MAX_K}]")
    d = x.shape[1]
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    if d == 0:
        return sums, centroid_partial_plain(x, assign, k)[1]
    err = _kernel("centroid_partial_launch")(
        x.data_ptr(), assign.data_ptr(), x.shape[0], k, d, sums.data_ptr(),
        counts.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "centroid_partial")
    partial_launches += 1
    return sums, counts


@_cost.counted("centroid_finish",
               lambda c, s, n, w, *, result: finish_work(*c.shape))
def centroid_finish(centroids: torch.Tensor, sums: torch.Tensor,
                    counts: torch.Tensor, weight: float) -> torch.Tensor:
    """``(w * c + sums) / (w + counts)`` with the multiply-add fused, as
    :func:`centroid_update` finishes: the update from partial sums and
    counts already summed over the blocks.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel's finish entry."""
    global finish_launches
    if not (centroids.dtype == sums.dtype == counts.dtype == torch.float32):
        raise TypeError("centroid_finish takes float32 tensors")
    k, d = centroids.shape
    if sums.shape != (k, d) or counts.shape != (k,):
        raise ValueError(f"centroid_finish: centroids (k, d), sums (k, d), "
                         f"counts (k,); got {tuple(centroids.shape)}, "
                         f"{tuple(sums.shape)}, {tuple(counts.shape)}")
    if centroids.device.type == "cpu":
        return centroid_finish_plain(centroids, sums, counts, weight)
    dev = _cuda_ready("centroid_finish", centroids, sums, counts)
    out = torch.empty_like(centroids)
    if k * d == 0:
        return out
    err = _kernel("centroid_finish_launch")(
        centroids.data_ptr(), sums.data_ptr(), counts.data_ptr(), k, d,
        float(weight), out.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "centroid_finish")
    finish_launches += 1
    return out
