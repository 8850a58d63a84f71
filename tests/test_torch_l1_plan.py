"""Kernels D's and C's summation plans on the CPU.

``csrc/l1_topk2.cu`` (kernel D) sums each window of the reference's order
as its own chain and folds the window sums level by level, over chunks of
the feature axis (``kernels/l1_topk2.py:window_plan``).  :func:`chunked_sum`
walks the same chunks, windows and folds in numpy f32 (every add one
rounding), so these tests hold the kernel's order to :func:`ordered_sum`
and to the JAX reference at feature widths of every window depth (none to
three levels).  Kernel C's warp classify (``csrc/serve_fused.cu``) stages
the axis in chunks of ``SERVE_CW`` level-0 windows instead, and folds each
window sum into the level-1 and level-2 windows as it comes
(``L1Fold`` of ``csrc/l1_topk2.cuh``); :func:`warp_chunked_sum` walks that
order and is held to the same two references.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro_torch.kernels import l1_topk2 as L1
from _torch_threads import one_torch_thread  # noqa: F401

WIN = 32
#: kernel C's level-0 windows per staged chunk, read from its source
SERVE_CW = int(re.search(
    r"#define SERVE_CW (\d+)",
    (Path(L1.__file__).parent / "csrc" / "serve_fused.cu").read_text()
).group(1))


def chunked_sum(a: np.ndarray) -> np.ndarray:
    """Sum the last axis of f32 ``a`` in the kernel's order: per chunk (one
    level-1 window, or the whole axis when it has at most 32 windows) each
    level-0 window from 0 in index order, the chunk's window sums in order,
    then the chunk sums into the level-2 windows and the top sum."""
    d = a.shape[-1]
    nwin, lo0, lo1, lo2, n1, n2 = L1.window_plan(d)
    zero = np.zeros(a.shape[:-1], np.float32)
    top, acc2, cur2 = zero.copy(), zero.copy(), 0
    for ch in range(n2 if nwin >= 2 else 1):
        wa, wb = 0, n1
        if nwin >= 2:
            wa, wb = max(0, ch * WIN - lo1), min(n1, ch * WIN + WIN - lo1)
        v = zero.copy()
        for w in range(wa, wb):
            base = w * WIN - lo0
            s = zero.copy()
            for j in range(max(0, -base), min(WIN, d - base)):
                s = s + a[..., base + j]
            v = v + s
        if nwin <= 1:
            top = v
        elif nwin == 2:
            top = top + v
        else:
            w2 = (ch + lo2) >> 5
            if w2 != cur2:
                top, acc2, cur2 = top + acc2, zero.copy(), w2
            acc2 = acc2 + v
    return top + acc2 if nwin == 3 else top


def warp_chunked_sum(a: np.ndarray, cw: int = SERVE_CW) -> np.ndarray:
    """Sum the last axis of f32 ``a`` in kernel C's order: the level-0
    windows in chunks of ``cw``, each window a chain from 0 in index order,
    and each window sum folded in window order (``L1Fold``): into its
    level-1 window (a new window pushes the finished one's sum to level 2),
    level-2 windows likewise, and the top sum."""
    d = a.shape[-1]
    nwin, lo0, lo1, lo2, n1, n2 = L1.window_plan(d)
    zero = np.zeros(a.shape[:-1], np.float32)
    st = dict(acc1=zero.copy(), acc2=zero.copy(), top=zero.copy(), cur1=0,
              cur2=0)

    def up(i, v):                      # element i of level 2
        if nwin == 2:
            st["top"] = st["top"] + v
            return
        w2 = (i + lo2) >> 5
        if w2 != st["cur2"]:
            st["top"], st["acc2"], st["cur2"] = (st["top"] + st["acc2"],
                                                 zero.copy(), w2)
        st["acc2"] = st["acc2"] + v

    def add(w, v):                     # window sum w, in window order
        if nwin <= 1:
            st["top"] = st["top"] + v
            return
        w1 = (w + lo1) >> 5
        if w1 != st["cur1"]:
            up(st["cur1"], st["acc1"])
            st["acc1"], st["cur1"] = zero.copy(), w1
        st["acc1"] = st["acc1"] + v

    for wa in range(0, n1, cw):
        sums = []
        for w in range(wa, min(n1, wa + cw)):     # the chunk's chains
            base = w * WIN - lo0
            s = zero.copy()
            for j in range(max(0, -base), min(WIN, d - base)):
                s = s + a[..., base + j]
            sums.append(s)
        for k, s in enumerate(sums):              # then their fold
            add(wa + k, s)
    if nwin >= 2:
        up(st["cur1"], st["acc1"])
    return st["top"] + st["acc2"] if nwin == 3 else st["top"]


@pytest.mark.parametrize("d", [1, 31, 32, 33, 150, 257, 1025, 8193, 32768,
                               32769, 40000])
def test_kernel_order_equals_ordered_sum(d):
    rng = np.random.default_rng(d)
    a = np.abs(rng.normal(size=(3, d))).astype(np.float32)
    want = L1.ordered_sum(torch.from_numpy(a)).numpy()
    assert np.array_equal(chunked_sum(a), want)


@pytest.mark.parametrize("d", [33, 150, 1025, 8193])
def test_kernel_order_matches_jax(d):
    """The L1 distances in the kernel's order give the JAX reference's
    d1 / d2 / idx bit for bit (per-row centroids at the serve shape's k)."""
    rng = np.random.default_rng(d + 1)
    x = rng.normal(size=(4, d)).astype(np.float32)
    c = rng.normal(size=(5, d)).astype(np.float32)
    dist = chunked_sum(np.abs(x[:, None, :] - c[None]))
    ref = JO.l1_topk2(x, c)
    idx = dist.argmin(-1)
    masked = np.where(np.arange(5) == idx[:, None], np.float32(L1.POS), dist)
    assert np.array_equal(dist.min(-1), np.asarray(ref[0]))
    assert np.array_equal(masked.min(-1), np.asarray(ref[1]))
    assert np.array_equal(idx, np.asarray(ref[2]))


@pytest.mark.parametrize("d", [1, 31, 32, 33, 150, 257, 1025, 1100, 8193,
                               32768, 32769, 40000])
def test_warp_order_equals_ordered_sum(d):
    """Kernel C's chunks of ``SERVE_CW`` windows and its streamed fold give
    ``ordered_sum``'s bits at every window depth."""
    rng = np.random.default_rng(d + 7)
    a = np.abs(rng.normal(size=(3, d))).astype(np.float32)
    want = L1.ordered_sum(torch.from_numpy(a)).numpy()
    assert np.array_equal(warp_chunked_sum(a), want)
    assert np.array_equal(warp_chunked_sum(a, cw=1), want)


@pytest.mark.parametrize("d", [33, 150, 1100])
def test_warp_order_matches_jax(d):
    """Kernel C's classify order gives the JAX reference's d1 / d2 / idx
    bit for bit (per-row centroids at the serve shape's k)."""
    rng = np.random.default_rng(d + 2)
    x = rng.normal(size=(4, d)).astype(np.float32)
    c = rng.normal(size=(5, d)).astype(np.float32)
    dist = warp_chunked_sum(np.abs(x[:, None, :] - c[None]))
    ref = JO.l1_topk2(x, c)
    idx = dist.argmin(-1)
    masked = np.where(np.arange(5) == idx[:, None], np.float32(L1.POS), dist)
    assert np.array_equal(dist.min(-1), np.asarray(ref[0]))
    assert np.array_equal(masked.min(-1), np.asarray(ref[1]))
    assert np.array_equal(idx, np.asarray(ref[2]))


@pytest.mark.parametrize("d,plan", [
    (32, (0, 0, 0, 0, 1, 1)), (150, (1, 5, 0, 0, 5, 1)),
    (8193, (2, 15, 15, 0, 257, 9)), (40000, (3, 0, 15, 12, 1250, 40))])
def test_window_plan_levels(d, plan):
    assert L1.window_plan(d) == plan
