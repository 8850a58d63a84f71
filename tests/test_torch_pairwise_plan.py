"""Kernel F's (``pairwise_l1``) schedule on the CPU.

``csrc/pairwise_l1.cu`` computes one ``T x T`` output tile per block
(``tile_plan``) and walks its windows of 32 columns, the feature blocks'
windows one after the other: each window is staged from block-relative
column ``32 v - lo0``, with zeros outside ``[0, len)`` of its feature
block and past the last row of ``x`` or ``y`` (by 16-byte or 4-byte
copies, ``copy_path``); each output sums the window's chunks of 4 columns
that hold columns of the block as one chain from ``+0.f``;
the chain folds into the block sum at the window's end (one running sum
when the block has at most 32 windows, else the three-level fold of
``l1_topk2.cuh``); at a block's end its sums are added into the output in
block order.  :func:`kernel_walk` takes the same steps in numpy f32 (every
subtraction and add one rounding), so these tests hold the kernel's
schedule to the plain version (and through it to the JAX package) bit for
bit.  With ``skip=False`` the walk sums all 32 staged columns of every
window of every block, zeros included: the reference's padded layout,
which gives the same bits.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JO
from repro_torch.kernels import pairwise_l1 as PW
from repro_torch.kernels.l1_topk2 import window_plan
from test_torch_gpu import PW_CASES
from _torch_threads import one_torch_thread  # noqa: F401

SRC = (Path(PW.__file__).parent / "csrc" / "pairwise_l1.cu").read_text()
WIN = 32


class Fold:
    """The fold of one block's window sums, for a tile of outputs: one
    running sum (at most one window level), else the level-1 and level-2
    windows and the top sum of ``L1Fold``."""

    def __init__(self, plan, shape):
        self.nwin, _, self.lo1, self.lo2 = plan[:4]
        self.acc1, self.acc2, self.top = (np.zeros(shape, np.float32)
                                          for _ in range(3))
        self.cur1 = self.cur2 = 0

    def add(self, w, v):
        if self.nwin <= 1:
            self.top = self.top + v
            return
        w1 = (w + self.lo1) >> 5
        if w1 != self.cur1:
            self._up()
            self.acc1 = np.zeros_like(self.acc1)
            self.cur1 = w1
        self.acc1 = self.acc1 + v

    def _up(self):
        if self.nwin == 2:
            self.top = self.top + self.acc1
            return
        w2 = (self.cur1 + self.lo2) >> 5
        if w2 != self.cur2:
            self.top = self.top + self.acc2
            self.acc2 = np.zeros_like(self.acc2)
            self.cur2 = w2
        self.acc2 = self.acc2 + self.acc1

    def finish(self):
        if self.nwin <= 1:
            return self.top
        self._up()
        return self.top + self.acc2 if self.nwin == 3 else self.top


def kernel_walk(x, y, block_d=512, *, tile=None, skip=True):
    """``(B1, B2)`` distances in the kernel's schedule (see the module
    docstring); ``tile`` defaults to the wrapper's choice."""
    B1, d = x.shape
    B2 = y.shape[0]
    bd = min(block_d, d)
    tile = tile or PW.tile_plan(B1, B2, bd)
    plan = window_plan(bd)
    lo0 = plan[1]
    nb = -(-d // bd)
    nv = (bd + lo0 + WIN - 1) // WIN
    last = d - (nb - 1) * bd
    nq = ((nb - 1) * nv + (last + lo0 + WIN - 1) // WIN if skip
          else nb * nv)
    out = np.empty((B1, B2), np.float32)
    for r0 in range(0, B1, tile):
        for c0 in range(0, B2, tile):
            X = np.zeros((tile, d), np.float32)
            Y = np.zeros((tile, d), np.float32)
            X[:min(tile, B1 - r0)] = x[r0:r0 + tile]
            Y[:min(tile, B2 - c0)] = y[c0:c0 + tile]
            fold, tot = Fold(plan, (tile, tile)), None
            for q in range(nq):
                b, v = divmod(q, nv)
                base, ln, cw = b * bd, min(bd, d - b * bd), WIN * v - lo0
                xs = np.zeros((WIN, tile), np.float32)
                ys = np.zeros((WIN, tile), np.float32)
                for k in range(WIN):      # the stage, zero-filled
                    if 0 <= cw + k < ln:
                        xs[k] = X[:, base + cw + k]
                        ys[k] = Y[:, base + cw + k]
                # the chunks of 4 that hold columns of the block
                klo, khi = ((max(0, -cw) // 4 * 4,
                             -(-min(WIN, ln - cw) // 4) * 4) if skip
                            else (0, WIN))
                acc = np.zeros((tile, tile), np.float32)
                for k in range(klo, khi):
                    acc = acc + np.abs(xs[k][:, None] - ys[k][None, :])
                fold.add(v, acc)
                if q == nq - 1 or v == nv - 1:   # the end of block b
                    bs = fold.finish()
                    fold = Fold(plan, (tile, tile))
                    tot = (np.float32(0) if b == 0 else tot) + bs
            out[r0:r0 + tile, c0:c0 + tile] = tot[:min(tile, B1 - r0),
                                                  :min(tile, B2 - c0)]
    return out


def _inputs(B1, B2, d, special=False):
    rng = np.random.default_rng(B1 * 7919 + B2 * 31 + d)
    x = rng.normal(size=(B1, d)).astype(np.float32)
    y = rng.normal(size=(B2, d)).astype(np.float32)
    if special:
        for a in (x, y):
            flat = a.reshape(-1)
            for v in (np.nan, np.inf, -np.inf):
                flat[rng.random(flat.size) < 0.25 / d] = v
    return x, y


def _plain(x, y, bd):
    return PW.pairwise_l1_plain(torch.from_numpy(x), torch.from_numpy(y),
                                block_d=bd).numpy()


def _assert_bits(a, b):
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(np.where(nan, 0, a).view(np.uint32),
                                  np.where(nan, 0, b).view(np.uint32))


def _walk(*args, **kw):
    with np.errstate(invalid="ignore"):
        return kernel_walk(*args, **kw)


def test_constants_match_the_kernel():
    cases = {int(t) for t in re.findall(r"case (\d+):", SRC)}
    assert cases == set(PW.TILES)
    multi = re.findall(r"launch<(\d+), (\d+), true>", SRC)
    assert multi == [("64", "64")] and PW.tile_plan(1, 1, 1100) == 64
    assert re.search(r"constexpr int PW_THREADS = 256;", SRC)
    for t in PW.TILES:    # 16 x 16 threads; 16-byte copies of t/32 rows
        assert t % 32 == 0 and f"launch<{t}, {t}, false>" in SRC


@pytest.mark.parametrize("d,bd,ptrs,want", [
    (512, 512, (0, 16), "16-byte"), (6, 512, (0, 0), "4-byte"),
    (64, 512, (0, 4), "4-byte"), (1100, 512, (0, 0), "16-byte"),
    (1000, 300, (0, 0), "4-byte"),        # lo0 = 10
    (1000, 296, (0, 0), "16-byte"),       # lo0 = 12
    (450, 100, (0, 0), "4-byte"),         # lo0 = 14
    (40, 20, (0, 0), "16-byte"), (42, 20, (0, 0), "4-byte")])
def test_copy_path_rule(d, bd, ptrs, want):
    assert PW.copy_path(d, min(bd, d), *ptrs) == want


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_copy_path_of_tensor_views(offset):
    """A contiguous view that starts off 16 bytes takes the 4-byte copies."""
    buf = torch.zeros(16 * 64 + offset)
    x = buf[offset:].view(16, 64)
    want = "4-byte" if offset % 4 else "16-byte"
    assert PW.copy_path(64, 64, x.data_ptr()) == want


@pytest.mark.parametrize("B1,B2,d,bd", PW_CASES)
def test_kernel_walk_matches_plain(B1, B2, d, bd):
    """Every shape of the card's test: the walk with the wrapper's tile."""
    x, y = _inputs(B1, B2, d)
    _assert_bits(_walk(x, y, bd), _plain(x, y, bd))


@pytest.mark.parametrize("B1,B2,d,bd", [
    (40, 24, 97, 512), (40, 24, 98, 512), (40, 24, 99, 512),  # d % 4 = 1-3
    (35, 29, 1000, 300), (21, 19, 450, 100), (13, 11, 301, 300),
    (9, 5, 1100, 2048), (6, 7, 2100, 2048), (5, 3, 31, 512),
    (4, 6, 70, 16)])
def test_kernel_walk_ragged_blocks_match_plain(B1, B2, d, bd):
    """Ragged ``d``, ``bd % 32 != 0`` with several feature blocks (a
    window that crosses into the next block reads zeros), two window
    levels, ``bd`` under one window."""
    x, y = _inputs(B1, B2, d)
    _assert_bits(_walk(x, y, bd), _plain(x, y, bd))


@pytest.mark.parametrize("tile", PW.TILES)
@pytest.mark.parametrize("delta", [-1, 1])
def test_kernel_walk_tile_edges_match_plain(tile, delta):
    """``B1`` and ``B2`` one below and one above a tile, on each tile."""
    x, y = _inputs(tile + delta, tile - delta, 45)
    _assert_bits(_walk(x, y, 40, tile=tile), _plain(x, y, 40))


@pytest.mark.parametrize("B1,B2,d,bd", [(33, 17, 1100, 512),
                                        (37, 23, 101, 64),
                                        (35, 29, 1000, 300),
                                        (9, 5, 1100, 2048),
                                        (5, 3, 31, 512)])
def test_zero_filled_windows_give_the_same_bits(B1, B2, d, bd):
    """Summing all 32 staged columns of every window of every block
    (zeros included) equals summing only the block's columns: adding
    ``|0 - 0| = +0`` to a chain that starts at ``+0.f`` is exact."""
    x, y = _inputs(B1, B2, d)
    _assert_bits(_walk(x, y, bd, skip=False), _walk(x, y, bd))


@pytest.mark.parametrize("B1,B2,d,bd", [(64, 48, 100, 512),
                                        (33, 17, 1100, 300),
                                        (9, 5, 1100, 2048)])
def test_kernel_walk_nan_and_inf_match_plain(B1, B2, d, bd):
    x, y = _inputs(B1, B2, d, special=True)
    ref = _plain(x, y, bd)
    assert np.isnan(ref).any() and np.isinf(ref).any()
    _assert_bits(_walk(x, y, bd), ref)
    _assert_bits(_walk(x, y, bd, skip=False), ref)


@pytest.mark.parametrize("B1,B2,d,bd", [(33, 17, 1100, 512),
                                        (37, 23, 101, 64),
                                        (16, 16, 6, 512)])
def test_kernel_walk_matches_jax(B1, B2, d, bd):
    x, y = _inputs(B1, B2, d)
    want = np.asarray(JO.pairwise_l1(jnp.asarray(x), jnp.asarray(y),
                                     block_b1=16, block_b2=16, block_d=bd))
    _assert_bits(_walk(x, y, bd), want)


@pytest.mark.parametrize("B1,B2,bd,tile", [
    (256, 256, 6, 32), (4096, 4096, 512, 128), (1000, 1000, 64, 64),
    (1500, 1500, 20, 128), (9, 5, 1100, 64), (1, 1, 1, 32),
    (200000, 3, 512, 128)])
def test_tile_plan(B1, B2, bd, tile):
    """The largest tile whose grid gives each of the 132 SMs a block, else
    32; 64 with the three-level fold."""
    assert PW.tile_plan(B1, B2, bd) == tile
