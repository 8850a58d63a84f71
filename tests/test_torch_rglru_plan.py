"""Kernel I's (``rglru_scan``) launch plan on the CPU.

``csrc/rglru_scan.cu`` feeds one warp per lane tile through a ring of step
tiles filled by 3-D TMA boxes or by 4-byte ``cp.async``.  The host picks
the copy path (``kernels/rglru_scan.py:copy_path``): TMA only where every
row of the ``(B, S, W)`` tensor starts on 16 bytes.  These tests hold that
rule, the tiles' cover of ``(S, W)``, and the kernel's constants against
the module's, and check that the plain version (which the kernel is held
to on the card) is the same step-by-step recurrence when it is walked one
step tile at a time with the carry handed on.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core._fma import fma_f32
from repro_torch.kernels import rglru_scan as RS
from _torch_threads import one_torch_thread  # noqa: F401

SRC = (Path(RS.__file__).parent / "csrc" / "rglru_scan.cu").read_text()


def test_constants_match_the_kernel():
    assert int(re.search(r"constexpr int TS = (\d+);", SRC).group(1)) \
        == RS.STEP_TILE
    assert int(re.search(r"constexpr int LANES = (\d+);", SRC).group(1)) \
        == RS.LANES == 32


@pytest.mark.parametrize("W,ptrs,want", [
    (4096, (0, 16, 4096), "tma"),
    (4100, (256, 512, 1024), "tma"),
    (4, (16, 32), "tma"),
    (53, (0, 0), "cp.async"),        # rows start off 16 bytes
    (33, (0, 0), "cp.async"),
    (4098, (0, 0), "cp.async"),      # W % 4 == 2
    (4096, (4, 0), "cp.async"),      # an offset view of a
    (4096, (0, 16, 8), "cp.async"),  # h off 16 bytes
])
def test_copy_path_rule(W, ptrs, want):
    assert RS.copy_path(W, *ptrs) == want


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_copy_path_of_tensor_views(offset):
    """A contiguous view that starts ``offset`` floats into its storage
    takes the TMA path only when it starts on 16 bytes."""
    B, S, W = 2, 5, 64
    flat = torch.zeros(B * S * W + 8)
    lead = -flat.data_ptr() % 16 // 4   # floats up to a 16-byte address
    a = flat[lead + offset:lead + offset + B * S * W].view(B, S, W)
    assert a.is_contiguous()
    want = "tma" if offset % 4 == 0 else "cp.async"
    assert RS.copy_path(W, a.data_ptr()) == want


@pytest.mark.parametrize("S,W", [(1, 1), (7, 53), (31, 33), (32, 32),
                                 (33, 4100), (4096, 4096), (512, 4096),
                                 (1030, 4100)])
def test_tile_plan_covers_once(S, W):
    steps, lanes = RS.tile_plan(S, W)
    for tiles, n, size in ((steps, S, RS.STEP_TILE), (lanes, W, RS.LANES)):
        hit = np.zeros(n, np.int64)
        for lo, hi in tiles:
            assert 0 < hi - lo <= size and lo % size == 0
            hit[lo:hi] += 1
        assert (hit == 1).all()
        assert len(tiles) == -(-n // size)


@pytest.mark.parametrize("B,S,W", [(2, 130, 33), (1, 64, 40), (3, 1, 5)])
def test_tile_walk_matches_plain(B, S, W):
    """The recurrence walked tile by tile over ``tile_plan`` (the carry
    handed from one step tile to the next, each lane tile on its own)
    equals the plain version bit for bit."""
    rng = np.random.default_rng(S * W)
    a = torch.from_numpy(rng.uniform(0.7, 0.999, (B, S, W)).astype(
        np.float32))
    b = torch.from_numpy((rng.normal(size=(B, S, W)) * 0.1).astype(
        np.float32))
    h0 = torch.from_numpy(rng.normal(size=(B, W)).astype(np.float32))
    steps, lanes = RS.tile_plan(S, W)
    h = torch.empty_like(a)
    last = torch.empty_like(h0)
    for wl, wh in lanes:
        carry = h0[:, wl:wh]
        for sl, sh in steps:
            for t in range(sl, sh):
                carry = fma_f32(a[:, t, wl:wh], carry, b[:, t, wl:wh])
                h[:, t, wl:wh] = carry
        last[:, wl:wh] = carry
    rh, rl = RS.rglru_scan_plain(a, b, h0)
    assert torch.equal(h, rh) and torch.equal(last, rl)
