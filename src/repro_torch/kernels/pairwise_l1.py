"""All-pairs L1 distance matrix (kernel F).

Replaces the Pallas TPU kernel ``repro/kernels/pairwise_l1.py:pairwise_l1``:
``x`` ``(B1, d)``, ``y`` ``(B2, d)`` -> ``(B1, B2)`` with
``out[i, j] = sum_f |x[i, f] - y[j, f]|``.  The forecaster seeds its
cluster table farthest-point-first from this matrix
(:mod:`repro_torch.adapt.forecast`).

Summation order: the reference reads the feature axis in blocks of
``bd = min(block_d, d)`` columns, the last block zero-padded to ``bd``;
each block is reduced in the window-32 order of :func:`ordered_sum` and the
block sums are added in order into a zeroed output.  ``block_d`` therefore
fixes the result and is kept; ``block_b1``/``block_b2`` only tile the
reference's grid and are accepted and ignored.  The plain version and the
CUDA kernel (``csrc/pairwise_l1.cu``) both take this order, so they agree
bit for bit, and both agree bit for bit with the JAX package on the CPU.

The kernel computes a square output tile per block of 256 threads, each
thread a register micro-tile, over windows of 32 columns staged in shared
memory (``csrc/pairwise_l1.cu``); :func:`tile_plan` picks the tile and
:func:`copy_path` the copies that stage a window, per call.  The launch
function is bound once and takes the window levels of ``bd``
(:func:`~repro_torch.kernels.l1_topk2.window_plan`), the tile and the copy
path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _cost
from .l1_topk2 import _MAX_D, _plan_arg, ordered_sum, window_plan

#: launches of the CUDA kernel (the plain version never counts)
launches = 0

# the plain version materialises (rows, B2, bd) terms; rows are taken in
# chunks of at most this many terms so large calls stay within memory
_PLAIN_TERMS = 1 << 26
#: the kernel's output tile edges: 8 x 8, 4 x 4 and 2 x 2 outputs per thread
TILES = (128, 64, 32)
#: blocks that fill the card: one per SM of the H100
_SMS = 132
_MAX_TILES = 2 ** 31 - 1   # blocks of the launch's one-dimensional grid


def _block(d: int, block_d: int) -> int:
    if block_d < 1:
        raise ValueError(f"pairwise_l1: block_d must be >= 1, got {block_d}")
    return min(block_d, d)


def pairwise_l1_plain(x: torch.Tensor, y: torch.Tensor, *,
                      block_d: int = 512) -> torch.Tensor:
    """The plain PyTorch version (same arithmetic, same order)."""
    B1, d = x.shape
    B2 = y.shape[0]
    out = torch.zeros((B1, B2), dtype=torch.float32, device=x.device)
    if B1 == 0 or B2 == 0 or d == 0:
        return out
    bd = _block(d, block_d)
    rows = max(1, _PLAIN_TERMS // max(B2 * bd, 1))
    for r0 in range(0, B1, rows):
        xr = x[r0:r0 + rows]
        acc = torch.zeros((xr.shape[0], B2), dtype=torch.float32,
                          device=x.device)
        for base in range(0, d, bd):
            xb, yb = xr[:, base:base + bd], y[:, base:base + bd]
            if xb.shape[1] < bd:      # the zero-padded last block
                pad = bd - xb.shape[1]
                xb = torch.nn.functional.pad(xb, (0, pad))
                yb = torch.nn.functional.pad(yb, (0, pad))
            acc = acc + ordered_sum(torch.abs(xb[:, None, :] - yb[None]))
        out[r0:r0 + rows] = acc
    return out


@functools.lru_cache(maxsize=256)
def tile_plan(B1: int, B2: int, bd: int) -> int:
    """The output tile edge the kernel takes for a ``(B1, B2)`` call with
    feature blocks of ``bd``: 64 where a block has two or more window
    levels (``bd > 1,024``: the three-level fold of 16 outputs per thread),
    else the largest of 128 and 64 whose grid gives every SM of the card a
    block, else 32."""
    if window_plan(bd)[0] >= 2:
        return 64
    for tile in TILES[:-1]:
        if -(-B1 // tile) * -(-B2 // tile) >= _SMS:
            return tile
    return TILES[-1]


def copy_path(d: int, bd: int, *ptrs: int) -> str:
    """How the kernel stages a window: ``"16-byte"`` copies where every
    16-byte chunk of a window lies wholly inside or outside its feature
    block and starts on 16 bytes (``d``, ``bd`` and the front padding
    ``lo0`` of :func:`window_plan` multiples of 4, every pointer 16-byte
    aligned); else ``"4-byte"``."""
    if (d % 4 == 0 and bd % 4 == 0 and window_plan(bd)[1] % 4 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "16-byte"
    return "4-byte"


_FN = {}


def _kernel():
    """The launch function of the built library, bound once."""
    fn = _FN.get("launch")
    if fn is None:
        fn = _build.load("pairwise_l1").pairwise_l1_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["launch"] = fn
    return fn


def _check(x, y):
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("pairwise_l1 takes float32 x and y")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_l1: x must be (B1, d) and y (B2, d); "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError("pairwise_l1: x and y on different devices")


def work(B1: int, B2: int, d: int) -> _cost.Work:
    """One call: x and y read once, the ``(B1, B2)`` distances written
    once; 3 operations (difference, absolute value, sum) per element of
    each distance."""
    return _cost.Work(bytes=4 * ((B1 + B2) * d + B1 * B2),
                      ops=3.0 * B1 * B2 * d)


def _call_work(x, y, *, result, **blocks):
    return work(x.shape[0], y.shape[0], x.shape[1])


@_cost.counted("pairwise_l1", _call_work)
def pairwise_l1(x: torch.Tensor, y: torch.Tensor, *, block_b1: int = 128,
                block_b2: int = 128, block_d: int = 512) -> torch.Tensor:
    """``x`` ``(B1, d)``, ``y`` ``(B2, d)`` float32 -> ``(B1, B2)`` float32
    L1 distances.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (contiguous inputs only)."""
    global launches
    del block_b1, block_b2        # tiling only: the result does not depend
    _check(x, y)
    if x.device.type == "cpu":
        return pairwise_l1_plain(x, y, block_d=block_d)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_l1: unsupported device {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("pairwise_l1: the kernel takes contiguous tensors")
    B1, d = x.shape
    B2 = y.shape[0]
    if B1 == 0 or B2 == 0 or d == 0:
        return torch.zeros((B1, B2), dtype=torch.float32, device=x.device)
    bd = _block(d, block_d)
    if bd > _MAX_D:
        raise ValueError(f"pairwise_l1: block_d={bd} exceeds the kernel's "
                         f"{_MAX_D}")
    tile = tile_plan(B1, B2, bd)
    if -(-B1 // tile) * -(-B2 // tile) > _MAX_TILES:
        raise ValueError(f"pairwise_l1: B1={B1} x B2={B2} exceeds the "
                         f"kernel's grid of {_MAX_TILES} tiles")
    xp, yp = x.data_ptr(), y.data_ptr()
    vec = copy_path(d, bd, xp, yp) == "16-byte"
    out = torch.empty((B1, B2), dtype=torch.float32, device=x.device)
    err = _kernel()(xp, yp, B1, B2, d, bd, _plan_arg(bd), tile, vec,
                    out.data_ptr(), _build.stream_handle(x.device))
    _build.check(err, "pairwise_l1")
    launches += 1
    return out
