"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs.  Every test needs a CUDA card and skips
without one; the file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, fleet
from repro_torch.core import energy
from repro_torch.core import kmeans as km
from repro_torch.core import step as S
from repro_torch.core.agile import AgileCNN
from repro_torch.core.scheduler import JobProfile, TaskSpec
from repro_torch.kernels import centroid_update as CU
from repro_torch.kernels import decode_gqa as DG
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import fleet_priority as FP
from repro_torch.kernels import fleet_step
from repro_torch.kernels import l1_topk2 as L1
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_l1 as PW
from repro_torch.kernels import rglru_scan as RS
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.configs import get_config
from repro_torch.models import anytime as AT
from repro_torch.models import attention as PA
from repro_torch.models import cnn
from repro_torch.models import transformer as TF
from repro_torch.fleet.state import ServeCarry
from repro_torch.serve import (FleetServeEngine, Request, ServeConfig,
                               ServeEngine)
from repro_torch.serve.fleet_engine import _shift_log

pytestmark = pytest.mark.gpu

L1_CASES = [(1, 1, 1), (7, 33, 3), (50, 150, 5), (13, 257, 4), (9, 1025, 2),
            (5, 8193, 5), (64, 31, 8), (250, 150, 5)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("per_row", [False, True])
def test_l1_topk2_kernel_matches_plain(cuda, per_row):
    rng = np.random.default_rng(0)
    for B, d, k in L1_CASES:
        x = rng.normal(size=(B, d)).astype(np.float32)
        c = rng.normal(size=(B, k, d) if per_row else (k, d)).astype(
            np.float32)
        xg, cg = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
        n0 = L1.launches
        out = L1.l1_topk2(xg, cg)
        torch.cuda.synchronize()
        assert L1.launches == n0 + 1
        for a, b in zip(out, L1.l1_topk2_plain(xg, cg)):
            assert torch.equal(a, b), (B, d, k)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("B", [1031, 4099])
def test_l1_topk2_kernel_many_blocks_matches_plain(cuda, B, per_row):
    """Row counts that span many tiles and end mid-tile, at the serve
    path's d = 150, k = 5."""
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.normal(size=(B, 150)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(B, 5, 150) if per_row
                                    else (5, 150)).astype(np.float32))
    xg, cg = x.to(cuda), c.to(cuda)
    out = L1.l1_topk2(xg, cg)
    torch.cuda.synchronize()
    for a, b in zip(out, L1.l1_topk2_plain(xg, cg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [5, 8, 13])
def test_l1_topk2_kernel_window_levels_match_plain(cuda, k):
    """The plain version's outputs at the serve shapes and across the window
    levels (d up to 40,000), with one pass over the feature axis per group
    of 8 centroids (k = 13 takes two)."""
    rng = np.random.default_rng(7)
    for B, d, per_row in ((64, 150, True), (250, 150, False),
                          (9, 1025, True), (3, 40000, False)):
        x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
        c = torch.from_numpy(rng.normal(size=(B, k, d) if per_row
                                        else (k, d)).astype(np.float32))
        xg, cg = x.to(cuda), c.to(cuda)
        out = L1.l1_topk2(xg, cg)
        torch.cuda.synchronize()
        for a, b in zip(out, L1.l1_topk2_plain(xg, cg)):
            assert torch.equal(a, b), (B, d, k)


def test_centroid_update_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    for B, d, k in [(64, 8192, 5), (7, 33, 3), (300, 100, 4)]:
        c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
        a = torch.from_numpy(rng.integers(-1, k, B).astype(np.int32))
        c, x, a = c.to(cuda), x.to(cuda), a.to(cuda)
        out = CU.centroid_update(c, x, a, 32.0)
        torch.cuda.synchronize()
        assert torch.equal(out, CU.centroid_update_plain(c, x, a, 32.0))


@pytest.mark.parametrize("B", [392, 400, 448, 500, 512, 600, 768, 1000,
                               1024, 2048, 4096])
def test_centroid_update_kernel_row_order(cuda, B):
    """Kernel E == its plain version bit for bit at the row counts where
    the reference sums in blocks (k = 4, F = 6, rows from [0, 100),
    weight 10, so ``w * c`` rounds and the fused multiply-add shows)."""
    rng = np.random.default_rng(B)
    c = torch.from_numpy(rng.uniform(0, 100, (4, 6)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 100, (B, 6)).astype(np.float32))
    a = torch.from_numpy(rng.integers(-1, 4, B).astype(np.int32))
    c, x, a = c.to(cuda), x.to(cuda), a.to(cuda)
    out = CU.centroid_update(c, x, a, 10.0)
    torch.cuda.synchronize()
    assert torch.equal(out, CU.centroid_update_plain(c, x, a, 10.0))


def _cu_case(cuda, B, d, k, assign, seed, weight=32.0):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.uniform(0, 100, (k, d)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 100, (B, d)).astype(np.float32))
    c, x, a = c.to(cuda), x.to(cuda), torch.from_numpy(assign).to(cuda)
    n0 = CU.launches
    out = CU.centroid_update(c, x, a, weight)
    torch.cuda.synchronize()
    assert CU.launches == n0 + 1
    assert torch.equal(out, CU.centroid_update_plain(c, x, a, weight))


@pytest.mark.parametrize("k", [1, 2, 8, 9, 16, 17, 128])
def test_centroid_update_kernel_cluster_counts(cuda, k):
    """One cluster, and k at and past 8 and 16 clusters, up to the
    kernel's limit, with ignored rows below 0 and at or past k."""
    rng = np.random.default_rng(k)
    for B, d in ((300, 100), (1024, 8192), (2500, 67)):
        _cu_case(cuda, B, d, k, rng.integers(-1, k + 2, B).astype(np.int32),
                 seed=B + k)


@pytest.mark.parametrize("case", ["none assigned", "all past k",
                                  "one row", "ragged d"])
def test_centroid_update_kernel_edge_rows(cuda, case):
    """No row assigned (every centroid becomes w * c / w), every row at or
    past k, one assigned row, and d that is no multiple of 4 or of the
    column tile."""
    B, d, k = 64, 8192, 5
    a = np.full(B, -1, np.int32)
    if case == "all past k":
        a[:] = np.arange(B) % 3 + k
    elif case == "one row":
        a[37] = 2
    elif case == "ragged d":
        d = 8191
        a = np.random.default_rng(3).integers(-1, k, B).astype(np.int32)
    _cu_case(cuda, B, d, k, a, seed=len(case))


@pytest.mark.parametrize("k", [5, 9])
@pytest.mark.parametrize("B", [392, 400, 448, 500, 512, 600, 768, 1000,
                               1024, 2048, 4096])
def test_centroid_update_kernel_row_order_wider_k(cuda, B, k):
    """The row counts of ``test_centroid_update_kernel_row_order`` with 5
    and 9 clusters (F = 6, rows from [0, 100), weight 10)."""
    a = np.random.default_rng(B).integers(-1, k, B).astype(np.int32)
    _cu_case(cuda, B, 6, k, a, seed=B, weight=10.0)


def test_centroid_update_kernel_rejects_too_many_clusters(cuda):
    with pytest.raises(ValueError, match="exceeds"):
        CU.centroid_update(torch.zeros(CU.MAX_K + 1, 4, device=cuda),
                           torch.zeros(3, 4, device=cuda),
                           torch.zeros(3, dtype=torch.int32, device=cuda),
                           1.0)


# kernel G shapes: (B, S, Skv, H, KV, hd, causal, window, q_offset); the
# main path's (anytime_forward at 2 x 512 on qwen1.5-0.5b), causal 4,096,
# the long-context window, glm4-9b's GQA geometry, an odd length, a query
# offset, no mask, a row that sees no key, and recurrentgemma-9b's MQA
# geometry (16 heads on one kv head, hd 256) under a window; then groups
# that do not divide the 64-row tile: dbrx-132b's 48 heads on 8 (G = 6) at
# causal 4,096, groups of 3, 5, 12, 48 and 64, a non-causal S != Skv row
# (cross-attention) and a ragged length, both at G = 6
FLASH_CASES = [
    (1, 1024, 1024, 16, 1, 256, True, 512, 0),
    (1, 4096, 4096, 48, 8, 128, True, 0, 0),
    (2, 100, 100, 6, 2, 64, True, 0, 0),
    (1, 77, 77, 10, 2, 32, True, 16, 0),
    (1, 300, 300, 24, 2, 64, True, 0, 0),
    (1, 20, 20, 48, 1, 64, True, 0, 0),
    (1, 33, 33, 64, 1, 64, True, 0, 0),
    (2, 90, 200, 12, 2, 64, False, 0, 0),
    (1, 37, 37, 6, 1, 128, True, 0, 0),
    (2, 512, 512, 16, 16, 64, True, 0, 0),
    (1, 4096, 4096, 16, 16, 64, True, 0, 0),
    (1, 8192, 8192, 16, 16, 64, True, 4096, 0),
    (1, 4096, 4096, 32, 2, 128, True, 0, 0),
    (2, 37, 37, 4, 1, 16, True, 0, 0),
    (1, 64, 320, 8, 2, 64, True, 0, 256),
    (2, 100, 200, 4, 2, 80, False, 0, 0),
    (1, 256, 256, 2, 2, 256, True, 0, -200),
    (1, 4096, 4096, 32, 32, 80, True, 0, 0),   # stablelm-3b: hd 80, MHA
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, dtype):
    """Kernel G against its plain version on the same inputs, one launch
    per call: f32 within rtol 1e-4 / atol 1e-5 (the JAX sweep's
    tolerance), bf16 within 1e-5.  The two compute the same f32 arithmetic
    from the same inputs, p rounded to v's dtype in both, and differ only in
    the summation order inside a tile (a largest gap of 4.8e-7 on the
    H100), so a kernel that skipped the bf16 rounding of p fails here."""
    dt = getattr(torch, dtype)
    tol = (1e-4, 1e-5) if dtype == "float32" else (1e-5, 1e-5)
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, S, Skv, H, KV, hd, causal, window, qo in FLASH_CASES:
        q = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dt)
        k = torch.randn((B, Skv, KV, hd), generator=g, device=cuda).to(dt)
        v = torch.randn((B, Skv, KV, hd), generator=g, device=cuda).to(dt)
        n0 = FA.launches
        out = FA.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=qo)
        torch.cuda.synchronize()
        assert FA.launches == n0 + 1
        assert out.dtype == torch.float32 and bool(out.isfinite().all())
        want = FA.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_offset=qo)
        torch.testing.assert_close(out, want, rtol=tol[0], atol=tol[1],
                                   msg=lambda m: f"{(S, H, KV, hd)}: {m}")


# kernel G's bf16 tensor-core path: (B, S, Skv, H, KV, hd, causal, window,
# q_offset): every padded head dim (16, 32, 64, 128, 256, and 80 and 136
# that pad inside a block), groups of 1, 2 and 16, ragged lengths (37,
# 4,097), a query offset, windows that are no multiple of the 64-key tile,
# no mask, and rows that see no key (a negative offset); then groups that
# leave padding rows in the 64-row tile (128 at hd 256): 3, 5, 6, 12 and
# 48, dbrx-132b's 48 heads on 8 at hd 128, a non-causal S != Skv row and a
# ragged length at G = 6, and G = 6 at hd 256 (126 of 128 rows)
FLASH_TC_CASES = [
    (2, 37, 37, 2, 1, 16, True, 0, 0),
    (1, 500, 500, 48, 8, 128, True, 0, 0),
    (2, 100, 100, 6, 2, 64, True, 0, 0),
    (1, 77, 77, 10, 2, 32, True, 16, 0),
    (1, 300, 300, 24, 2, 80, True, 0, 0),
    (1, 20, 20, 48, 1, 64, True, 0, 0),
    (2, 90, 200, 12, 2, 128, False, 0, 0),
    (1, 37, 37, 6, 1, 128, True, 0, 0),
    (1, 130, 130, 6, 1, 256, True, 0, 0),
    (1, 64, 1024, 6, 1, 64, True, 0, 960),
    (1, 130, 130, 4, 2, 32, True, 0, 0),
    (1, 4097, 4097, 2, 2, 64, True, 0, 0),
    (1, 300, 4097, 16, 1, 128, True, 100, 3797),
    (1, 512, 512, 16, 1, 256, True, 300, 0),
    (2, 37, 101, 4, 4, 80, False, 0, 0),
    (1, 96, 96, 2, 1, 136, True, 0, -50),
    (1, 200, 200, 32, 2, 128, True, 70, 0),
    (2, 64, 64, 16, 16, 64, True, 0, -64),
]


def test_flash_attention_bf16_tensor_core_path(cuda):
    """Kernel G's bf16 instance (TMA tiles, wgmma for Q K^T and P V) against
    its plain version at ``FLASH_TOL`` (rtol = atol = 1e-5), one launch per
    call; f32 at the same shapes takes the SIMT kernel, held at 1e-4 /
    1e-5."""
    g = torch.Generator(device=cuda).manual_seed(6)
    for B, S, Skv, H, KV, hd, causal, window, qo in FLASH_TC_CASES:
        for dtype, tol in ((torch.bfloat16, (1e-5, 1e-5)),
                           (torch.float32, (1e-4, 1e-5))):
            assert FA.kernel_path(dtype, hd) == (
                "tensor-core" if dtype == torch.bfloat16 else "simt")
            q = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
            k = torch.randn((B, Skv, KV, hd), generator=g,
                            device=cuda).to(dtype)
            v = torch.randn((B, Skv, KV, hd), generator=g,
                            device=cuda).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=qo)
            n0 = FA.launches
            out = FA.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert FA.launches == n0 + 1
            assert bool(out.isfinite().all())
            case = (S, Skv, H, KV, hd, window, qo, dtype)
            torch.testing.assert_close(
                out, FA.flash_attention_plain(q, k, v, **kw), rtol=tol[0],
                atol=tol[1], msg=lambda m: f"{case}: {m}")


def test_flash_attention_bf16_rejects_what_the_tensor_cores_do_not_take(
        cuda):
    """A bf16 call whose head dim is no multiple of 8 raises (no fallback
    to the SIMT kernel); the same call in f32 runs."""
    q = torch.randn((1, 8, 2, 20), device=cuda)
    n0 = FA.launches
    with pytest.raises(ValueError):
        FA.flash_attention(*(t.bfloat16() for t in (q, q, q)))
    assert FA.launches == n0
    FA.flash_attention(q, q, q)
    assert FA.launches == n0 + 1


PW_CASES = [(1, 1, 1, 512), (1, 37, 6, 512), (16, 16, 6, 512),
            (256, 256, 6, 512), (37, 23, 101, 64), (33, 17, 1100, 512),
            (48, 72, 200, 512), (19, 1, 513, 512), (130, 97, 33, 512),
            (7, 5, 2000, 300), (1000, 1000, 64, 512), (1000, 999, 6, 512),
            (1500, 1500, 20, 512), (1601, 1499, 45, 40), (9, 5, 1100, 2048),
            (3, 2, 33000, 40000), (5, 6, 2200, 2048)]


def _pw_equal(a, b):
    """Bit for bit, NaN where the other has NaN (the card's NaN is one
    canonical pattern in both versions)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


def test_pairwise_l1_kernel_matches_plain(cuda):
    """Kernel F == its plain version bit for bit at odd sizes, B1 = 1, a
    two-block ``d``, the forecaster's shape, every tile instance (128 x
    128, 64 x 64, 32 x 32 and the three-level fold at ``bd`` > 1,024) on
    both copy paths, and window levels 0 to 3, one launch per call."""
    rng = np.random.default_rng(3)
    paths, levels = set(), set()
    for B1, B2, d, bd in PW_CASES:
        x = torch.from_numpy(rng.normal(size=(B1, d)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(B2, d)).astype(np.float32))
        x, y = x.to(cuda), y.to(cuda)
        n0 = PW.launches
        out = PW.pairwise_l1(x, y, block_d=bd)
        torch.cuda.synchronize()
        assert PW.launches == n0 + 1
        assert torch.equal(out, PW.pairwise_l1_plain(x, y, block_d=bd)), (
            B1, B2, d, bd)
        nwin = L1.window_plan(min(bd, d))[0]
        tile = (PW.tile_plan(B1, B2, min(bd, d)), nwin >= 2)
        paths.add(tile + (PW.copy_path(d, min(bd, d), x.data_ptr(),
                                       y.data_ptr()),))
        levels.add((tile[0], min(nwin, 2)))
    assert paths == {(t, m, p) for t, m in ((128, False), (64, False),
                                            (32, False), (64, True))
                     for p in ("16-byte", "4-byte")}
    assert levels == {(128, 0), (128, 1), (64, 0), (64, 1), (32, 0), (32, 1),
                      (64, 2)}
    same = PW.pairwise_l1(x, x)
    assert torch.equal(same, same.t()) and not bool(same.diagonal().any())


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_pairwise_l1_kernel_offset_views_match_plain(cuda, offset):
    """Contiguous views that start off 16 bytes take the 4-byte copies
    (``offset`` 4 floats is aligned again and takes the 16-byte ones)."""
    rng = np.random.default_rng(offset)
    B1, B2, d = 300, 200, 64
    buf = torch.from_numpy(rng.normal(size=(B1 + B2) * d + offset).astype(
        np.float32)).to(cuda)
    x = buf[offset:offset + B1 * d].view(B1, d)
    y = buf[offset + B1 * d:].view(B2, d)
    want = "4-byte" if offset % 4 else "16-byte"
    assert PW.copy_path(d, d, x.data_ptr(), y.data_ptr()) == want
    assert torch.equal(PW.pairwise_l1(x, y), PW.pairwise_l1_plain(x, y))


@pytest.mark.parametrize("B1,B2,d,bd", [(256, 256, 6, 512),
                                        (1000, 1000, 64, 512),
                                        (1601, 1499, 45, 40),
                                        (9, 5, 1100, 2048)])
def test_pairwise_l1_kernel_nan_and_inf_match_plain(cuda, B1, B2, d, bd):
    """NaN, +inf and -inf in x and y (inf - inf is NaN; inf - finite is
    inf) give the plain version's outputs on every tile instance."""
    rng = np.random.default_rng(B1 + d)
    x = rng.normal(size=(B1, d)).astype(np.float32)
    y = rng.normal(size=(B2, d)).astype(np.float32)
    for a in (x, y):      # about one row in four holds each value
        flat = a.reshape(-1)
        for v in (np.nan, np.inf, -np.inf):
            flat[rng.random(flat.size) < 0.25 / d] = v
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    out = PW.pairwise_l1(x, y, block_d=bd)
    ref = PW.pairwise_l1_plain(x, y, block_d=bd)
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    assert _pw_equal(out, ref)


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError):
        L1.l1_topk2(x.t(), torch.zeros(3, 8, device=cuda))   # strided
    with pytest.raises(ValueError):
        L1.l1_topk2(x, torch.zeros(3, 16))                   # mixed devices
    with pytest.raises(ValueError):
        CU.centroid_update(torch.zeros(16, 3, device=cuda).t(), x,
                           torch.zeros(8, dtype=torch.int32, device=cuda),
                           32.0)
    with pytest.raises(ValueError):
        PW.pairwise_l1(x.t(), torch.zeros(3, 8, device=cuda))   # strided
    with pytest.raises(TypeError):
        PW.pairwise_l1(x.double(), x.double())
    # kernel A: one compare against the expected operands, then each
    # operand's own check on a mismatch; a strided operand is copied
    ins = _priority_operands(cuda, 37, 3)
    kw = dict(n_tasks=2, dt=0.01)
    ref = FP.fleet_priority_plain(**ins, **kw)
    for other in (ins, dict(ins, laxity=ins["laxity"].t().contiguous().t())):
        for a, b in zip(FP.fleet_priority(**other, **kw), ref):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="laxity is torch.float64"):
        FP.fleet_priority(**dict(ins, laxity=ins["laxity"].double()), **kw)
    with pytest.raises(ValueError, match="energy .* on cpu"):
        FP.fleet_priority(**dict(ins, energy=ins["energy"].cpu()), **kw)
    with pytest.raises(ValueError, match="task is"):
        FP.fleet_priority(**dict(ins, task=ins["task"][:-1]), **kw)
    with pytest.raises(ValueError, match="exceeds"):
        FP.fleet_priority(**_priority_operands(cuda, 5, 9), **kw)


def _priority_operands(device, D, Q):
    """Kernel A's operands at ``(D, Q)``, random from numpy seed 9, by
    name."""
    rng = np.random.default_rng(9)
    ins = {}
    for f in FP._IN_VEC + FP._IN_ROW:
        shape = (D,) if f in FP._IN_VEC else (D, Q)
        dt = FP._DTYPES.get(f, torch.float32)
        if dt == torch.bool:
            a = rng.random(shape) < 0.6
        elif f == "policy":
            a = rng.integers(0, 4, shape)
        elif f in ("task", "rr_cursor"):
            a = rng.integers(0, 2, shape)
        elif f == "forced":
            a = rng.integers(-1, Q, shape) * (rng.random(shape) < 0.3)
        else:
            a = rng.uniform(0.0, 1.0, shape)
        ins[f] = torch.from_numpy(np.asarray(a)).to(device, dt)
    return ins


def _engine(device, adapt, bank_mode, n_tasks=2, queue_size=3):
    """Narrow agile CNNs on 32x32x3 inputs with fitted banks, one per task
    (the two specs in turn, each task its own seed)."""
    rng = np.random.default_rng(2)
    protos = np.kron(rng.normal(size=(3, 8, 8, 3)), np.ones((1, 4, 4, 1)))
    y = rng.integers(0, 3, 72).astype(np.int32)
    x = (1.5 * protos[y] + rng.normal(size=(72, 32, 32, 3))).astype(
        np.float32)
    specs = (("a", (32, 32, 3), ((4, 5, True), (8, 5, True)), (16,), 3),
             ("b", (32, 32, 3), ((6, 5, True),), (12, 8), 3))
    models = []
    for seed in range(n_tasks):
        cfg = cnn.CNNConfig(*specs[seed % 2])
        params = cnn.init_cnn_params(cfg, torch.Generator().manual_seed(seed),
                                     device=device)
        feats = cnn.cnn_forward_all(cfg, params,
                                    torch.from_numpy(x[:64]).to(device))
        bank = km.fit_bank([f.cpu().numpy() for f in feats], y[:64],
                           thresholds=[0.02] * cfg.n_units, device=device)
        models.append(AgileCNN(cfg, params, bank))
    reqs = [[Request(x[64 + j], int(y[64 + j]), release=2.0 * j)
             for j in range(4)] for _ in models]
    conf = ServeConfig(policy="zygarde", period=2.0, deadline=1.8,
                       horizon=10.0, adapt=adapt, unit_time=np.full(3, 0.3),
                       start_charged=True, queue_size=queue_size)
    eng = FleetServeEngine(models, energy.calibrate_harvester(0.71, 0.35),
                           eta=0.71, config=conf, bank_mode=bank_mode,
                           device=device)
    return eng, reqs


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_fused_kernel_matches_scan(cuda, bank_mode):
    """Kernel C, one launch per segment, == the scan (classify through
    kernel D) on every carry leaf."""
    eng, reqs = _engine(cuda, False, bank_mode)
    ops.reset_launch_counts()
    scan = eng.run(reqs, 5, seeds=range(5), n_segments=3)
    assert ops.launch_counts()["l1_topk2"] > 0
    fused = eng.run(reqs, 5, seeds=range(5), n_segments=3, mode="fused")
    assert ops.launch_counts()["serve_fused_steps"] == 3
    for part in ("dev", "bank", "log"):
        a_p, b_p = getattr(scan.carry, part), getattr(fused.carry, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            assert torch.equal(a, b), f"{part}.{f}"
    assert fleet_step.serve_launches >= 3


def test_scan_on_card_matches_cpu(cuda):
    """The serve loop on the card (kernel D) == the CPU's plain loop from
    the same built state, bit for bit."""
    eng, reqs = _engine(cuda, False, "per-device")
    cfg, statics, tables, carry0, _ = eng.build(reqs, 4, seeds=range(4))
    kw = dict(statics=statics, n_steps=statics.n_steps, adapt=False)
    on_card = eng._scan_steps(cfg, tables, carry0, 0, **kw)

    def cpu(tree):
        return type(tree)(*[cpu(v) if isinstance(v, tuple) else v.cpu()
                            for v in tree])

    on_cpu = eng._scan_steps(cpu(cfg), cpu(tables), cpu(carry0), 0, **kw)
    for part in ("dev", "bank", "log"):
        a_p, b_p = getattr(on_card, part), getattr(on_cpu, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            assert torch.equal(a.cpu(), b), f"{part}.{f}"


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_adaptive_serving_runs_through_the_kernels(cuda, bank_mode):
    eng, reqs = _engine(cuda, True, bank_mode)
    ops.reset_launch_counts()
    res = eng.run(reqs, 4, seeds=range(4))
    counts = ops.launch_counts()
    assert counts["l1_topk2"] > 0
    if bank_mode == "shared":
        assert counts["centroid_update"] > 0
    assert (res.exit_unit >= 0).any()
    assert np.isfinite(res.margin).all()


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_graphed_adaptive_scan_matches_eager(cuda, bank_mode):
    """The card's scan replays each step as two CUDA graphs around one
    launch of kernel D; with adaptation between the steps it equals the
    eager loop (the telemetry run's, which only adds outputs) on every
    carry leaf, with the same launches of kernels D and E."""
    from repro_torch import telemetry as TEL

    eng, reqs = _engine(cuda, True, bank_mode)
    runs, counts = [], []
    for tcfg in (None, TEL.TelemetryConfig(ring_size=16, level="counters")):
        ops.reset_launch_counts()
        runs.append(eng.run(reqs, 4, seeds=range(4), n_segments=3,
                            telemetry=tcfg))
        counts.append({k: ops.launch_counts()[k]
                       for k in ("l1_topk2", "centroid_update")})
    graphed, eager = runs
    assert counts[0] == counts[1] and counts[0]["l1_topk2"] > 0
    assert (graphed.exit_unit >= 0).any()
    for part in ("dev", "bank", "log"):
        a_p, b_p = getattr(graphed.carry, part), getattr(eager.carry, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            assert torch.equal(a, b), f"{part}.{f}"


def _leaves_equal(out, ref, what):
    """Every leaf equal, float leaves with their NaNs in the same places."""
    for f, a, b in zip(out._fields, out, ref):
        if a.dtype.is_floating_point:
            assert torch.equal(a.isnan(), b.isnan()), f"{what}.{f}"
            a, b = a.nan_to_num(), b.nan_to_num()
        assert torch.equal(a, b), f"{what}.{f}"


def _assert_serve_kernel_matches_plain(cfg, statics, tables, carry,
                                       segments=((0, 40), (40, None))):
    """Kernel C == its plain version (``n_steps`` calls of ``serve_step``)
    on every ``dev`` and ``log`` leaf, segment by segment from the plain
    carry (``None``: to the horizon).  Returns the plain carry."""
    K = cfg.period.shape[-1]
    job0 = torch.zeros(K, dtype=torch.int32, device=cfg.policy.device)
    for i0, n in segments:
        n = statics.n_steps - i0 if n is None else n
        n0 = fleet_step.serve_launches
        out = fleet_step.serve_fused_steps(cfg, carry, tables, i0, job0,
                                           statics=statics, n_steps=n)
        torch.cuda.synchronize()
        assert fleet_step.serve_launches == n0 + 1
        ref = fleet_step.serve_fused_steps_plain(cfg, carry, tables, i0, job0,
                                                 statics=statics, n_steps=n)
        for part in ("dev", "log"):
            _leaves_equal(getattr(out, part), getattr(ref, part),
                          f"i0={i0} {part}")
        assert out.bank is carry.bank
        carry = ref
    return carry


@pytest.mark.parametrize("queue_size,n_tasks", [(1, 2), (3, 2), (8, 2),
                                                (3, 8), (8, 8)])
def test_serve_fused_kernel_queue_sizes_and_tasks(cuda, queue_size, n_tasks):
    """Kernel C == plain on every carry and log leaf at queue sizes 1, 3
    and 8 with K = 2 and at K = 8 (every instance of the kernel), from the
    initial carry and from a mid-horizon one."""
    eng, reqs = _engine(cuda, False, "per-device", n_tasks, queue_size)
    cfg, statics, tables, carry0, _ = eng.build(reqs, 5, seeds=range(5))
    ref = _assert_serve_kernel_matches_plain(cfg, statics, tables, carry0)
    assert int(ref.dev.m_units.sum()) > 0 and bool(ref.log.units.any())


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_serve_fused_kernel_odd_fleet_per_device_streams(cuda, bank_mode):
    """An odd fleet (D = 37, a prime: several blocks, the last one part
    full) with per-device request streams (5-D ``sel_feats``, per-device
    labels), on a per-device and on a shared bank."""
    eng, reqs = _engine(cuda, False, bank_mode)
    rng = np.random.default_rng(37)
    streams = [[[reqs[k][j] for j in rng.permutation(len(reqs[k]))]
                for k in range(len(reqs))] for _ in range(37)]
    streams = [[[Request(r.x, r.label, release=2.0 * j)
                 for j, r in enumerate(task)] for task in dev]
               for dev in streams]
    cfg, statics, tables, carry0, per_dev = eng.build(streams)
    assert per_dev and tables.sel_feats.dim() == 5
    assert (carry0.bank.centroids.dim() == 4) == (bank_mode == "shared")
    _assert_serve_kernel_matches_plain(cfg, statics, tables, carry0)


def _synthetic_bank(tables, bank, S, C, seed):
    """The serve tables and a per-device bank re-made at ``S`` selected
    features and ``C`` centroids per (task, unit), numpy seed ``seed``;
    utility thresholds near the margins' median (which shrinks as
    1 / sqrt(S) on random rows), so units both pass and fail."""
    rng = np.random.default_rng(seed)
    dev = bank.centroids.device
    K, W, U = tables.sel_feats.shape[-4:-1]
    D = bank.centroids.shape[0]
    F = S + 7

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sel = rng.normal(size=(K, W, U, S)).astype(np.float32)
    fidx = rng.integers(0, F, (K, U, S)).astype(np.int32)
    cent = rng.normal(size=(D, K, U, C, F)).astype(np.float32)
    clab = rng.integers(0, 3, (K, U, C)).astype(np.int32)
    thr = np.full((K, U), 0.5 if C == 1 else 0.3 / np.sqrt(S), np.float32)
    tables = tables._replace(sel_feats=t(sel), fidx=t(fidx), clabels=t(clab),
                             thr=t(thr),
                             full_feats=t(np.zeros((K, W, U, F), np.float32)))
    bank = bank._replace(centroids=t(cent),
                         counts=t(np.ones((D, K, U, C), np.float32)))
    return tables, bank


@pytest.mark.parametrize("C", [1, 5, 8])
@pytest.mark.parametrize("S", [1, 32, 33, 150, 1100])
def test_serve_fused_kernel_classify_widths(cuda, S, C):
    """Kernel C's warp classify == plain at S = 1, 32 (window level 0),
    33, 150 (level 1) and 1,100 (level 2) selected features, against 1, 5
    and 8 centroids, on random tables and banks."""
    eng, reqs = _engine(cuda, False, "per-device")
    cfg, statics, tables, carry0, _ = eng.build(reqs, 7, seeds=range(7))
    tables, bank = _synthetic_bank(tables, carry0.bank, S, C, 100 * S + C)
    carry0 = carry0._replace(bank=bank)
    ref = _assert_serve_kernel_matches_plain(cfg, statics, tables, carry0)
    assert bool(ref.log.units.any())


def test_serve_fused_kernel_keeps_a_nan_charge(cuda):
    """Task 0's last unit at zero time drains ue * (dt / 0) = inf: a step
    that runs it leaves -inf, and one that selects it and does not run
    charges 0 * inf = NaN; the NaN stays in the energy as it does in the
    plain version (torch.minimum), every NaN in the same place, through
    later steps that select a unit of finite drain (where fminf would
    reset the charge to the capacity)."""
    eng, reqs = _engine(cuda, False, "per-device")
    cfg, statics, tables, carry0, _ = eng.build(reqs, 6, seeds=range(6))
    ut = cfg.unit_time.clone()
    ut[:, 0, -1] = 0.0
    cfg = cfg._replace(unit_time=ut.contiguous())
    ref = _assert_serve_kernel_matches_plain(cfg, statics, tables, carry0,
                                             segments=((0, None),))
    assert bool(ref.dev.energy.isnan().any())


# --------------------------------------------------------------------------- #
# The replay fleet: kernels A (fleet_priority) and B (fleet_fused_steps).
# --------------------------------------------------------------------------- #


def _replay_grid(n_seeds, horizon=6.0):
    """Two random periodic tasks (numpy seed 5) over all four policies, a
    bursty and a weak intermittent harvester and ``n_seeds`` seeds."""
    rng = np.random.default_rng(5)
    tasks = []
    for tid, (n_units, period) in enumerate(((3, 1.0), (5, 0.8))):
        profiles = [JobProfile(np.sort(rng.uniform(0.05, 0.6, n_units)),
                               rng.random(n_units) < 0.4,
                               rng.random(n_units) < 0.7)
                    for _ in range(int(horizon / period) + 2)]
        tasks.append(TaskSpec(tid, period, 1.8 * period,
                              np.full(n_units, 0.04),
                              np.full(n_units, 6e-3), profiles))
    grid = fleet.SweepGrid(
        task=tasks, policies=("zygarde", "edf", "edf-m", "rr"),
        etas=(0.7, 1.0), harvesters=(
            energy.Harvester("rf", 0.93, 0.93, 0.07),
            energy.Harvester("rf-strong", 0.93, 0.93, 0.7)),
        seeds=tuple(range(n_seeds)), horizon=horizon, dt=0.01)
    return grid


def _replay_cfg(device, n_seeds, horizon=6.0):
    """:func:`_replay_grid` built on ``device``."""
    cfg, statics, _ = fleet.build(_replay_grid(n_seeds, horizon), device)
    return cfg, statics


@pytest.mark.parametrize("n_seeds", [1, 3])
def test_fleet_priority_kernel_matches_plain(cuda, n_seeds):
    """Kernel A == its plain version on all four outputs, at every step of
    a plain run, at D = 16 and at the odd D = 48 - 1 (a prime)."""
    cfg, statics = _replay_cfg(cuda, n_seeds)
    D = cfg.policy.shape[0]
    carry = fleet.init_fleet(cfg, statics)
    n0 = FP.launches
    for i in range(0, statics.n_steps, 3):
        t = S.step_clock(i, statics.dt, cuda)
        carry = S.drop_expired(cfg, S.admit(cfg, carry, t, statics), t)
        lax, util, mand, gate_e, drain, power, forced, _ = S.pick_inputs(
            cfg, carry, t, statics)
        args = (cfg.policy, carry.q_active, lax, carry.q_release, util,
                mand, cfg.alpha, cfg.beta, cfg.eta, cfg.persistent,
                carry.energy, cfg.e_opt, power, cfg.capacity, gate_e, drain,
                forced, carry.q_task, carry.rr_cursor)
        kw = dict(n_tasks=2, dt=statics.dt)
        n = D if n_seeds == 1 else D - 1
        sub = tuple(a[:n] for a in args)
        out = FP.fleet_priority(*sub, **kw)
        ref = FP.fleet_priority_plain(*sub, **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b), i
        pick = FP.fleet_priority_plain(*args, **kw)
        carry = S.apply_step(cfg, carry, t, *pick, statics,
                             t_end=S.step_clock(i + 1, statics.dt, cuda))
    torch.cuda.synchronize()
    assert FP.launches - n0 == len(range(0, statics.n_steps, 3))


def test_fleet_priority_kernel_keeps_a_nan_charge(cuda):
    """Kernel A == plain with a NaN charge in ``energy`` on every third
    device (finite drains there: the clamp must keep the NaN), an infinite
    drain on every slot of other devices that do not run (0 * inf = NaN)
    and on the slots a running device did not select.  The NaN masks
    first, then the values."""
    cfg, statics = _replay_cfg(cuda, 3)
    D = cfg.policy.shape[0]
    carry = fleet_step.fleet_fused_steps_plain(
        cfg, fleet.init_fleet(cfg, statics), 0, statics=statics, n_steps=200)
    t = S.step_clock(200, statics.dt, cuda)
    carry = S.drop_expired(cfg, S.admit(cfg, carry, t, statics), t)
    lax, util, mand, gate_e, drain, power, forced, _ = S.pick_inputs(
        cfg, carry, t, statics)
    energy = carry.energy.clone()
    energy[::3] = float("nan")
    kw = dict(n_tasks=2, dt=statics.dt)

    def args(drain):
        return (cfg.policy, carry.q_active, lax, carry.q_release, util, mand,
                cfg.alpha, cfg.beta, cfg.eta, cfg.persistent, energy,
                cfg.e_opt, power, cfg.capacity, gate_e, drain, forced,
                carry.q_task, carry.rr_cursor)

    sel, _, run, _ = FP.fleet_priority_plain(*args(drain), **kw)
    d = torch.arange(D, device=cuda)[:, None]
    q = torch.arange(drain.shape[-1], device=cuda)[None, :]
    inf = torch.full_like(drain, float("inf"))
    drain = torch.where(((d % 3 == 1) & ~run[:, None])
                        | ((d % 3 == 2) & run[:, None] & (q != sel[:, None])),
                        inf, drain)
    n0 = FP.launches
    out = FP.fleet_priority(*args(drain), **kw)
    torch.cuda.synchronize()
    assert FP.launches == n0 + 1
    ref = FP.fleet_priority_plain(*args(drain), **kw)
    assert bool(ref[3][::3].isnan().all()) and bool(drain.isinf().any())
    for name, a, b in zip(("sel", "picked", "run", "e_new"), out, ref):
        if a.dtype.is_floating_point:
            assert torch.equal(a.isnan(), b.isnan()), name
            a, b = a.nan_to_num(), b.nan_to_num()
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n_steps", [1, 97])
def test_fleet_fused_kernel_matches_plain(cuda, n_steps):
    """Kernel B == its plain version on every carry leaf, from the initial
    carry and from mid-horizon, at an odd device count."""
    cfg, statics = _replay_cfg(cuda, 3)
    cfg = S.StepParams(*[x[:-1].contiguous() for x in cfg])   # D = 47
    carry = fleet.init_fleet(cfg, statics)
    for i0 in (0, 250):
        if i0:
            carry = fleet_step.fleet_fused_steps_plain(
                cfg, carry, 0, statics=statics, n_steps=i0)
        out = fleet_step.fleet_fused_steps(cfg, carry, i0, statics=statics,
                                           n_steps=n_steps)
        ref = fleet_step.fleet_fused_steps_plain(cfg, carry, i0,
                                                 statics=statics,
                                                 n_steps=n_steps)
        for f, a, b in zip(out._fields, out, ref):
            assert torch.equal(a, b), (i0, f)


def _replay_cfg_tasks(device, n_tasks, queue_size, n_seeds, horizon=6.0):
    """``n_tasks`` random periodic tasks of 2-5 units (numpy seed 11) over
    all four policies (zygarde and EDF-M imprecise, EDF-M exiting at the
    first pass), two harvesters and ``n_seeds`` seeds."""
    rng = np.random.default_rng(11)
    tasks = []
    for tid in range(n_tasks):
        n_units, period = 2 + tid % 4, 0.6 + 0.15 * (tid % 3)
        profiles = [JobProfile(np.sort(rng.uniform(0.05, 0.6, n_units)),
                               rng.random(n_units) < 0.4,
                               rng.random(n_units) < 0.7)
                    for _ in range(int(horizon / period) + 2)]
        tasks.append(TaskSpec(tid, period, 1.8 * period,
                              np.full(n_units, 0.04 + 0.01 * (tid % 2)),
                              np.full(n_units, 6e-3), profiles))
    grid = fleet.SweepGrid(
        task=tasks, policies=("zygarde", "edf", "edf-m", "rr"),
        etas=(0.7, 1.0), harvesters=(
            energy.Harvester("rf", 0.93, 0.93, 0.07),
            energy.Harvester("rf-strong", 0.93, 0.93, 0.7)),
        seeds=tuple(range(n_seeds)), horizon=horizon, dt=0.01,
        queue_size=queue_size)
    cfg, statics, _ = fleet.build(grid, device)
    return cfg, statics


def _assert_fused_matches_plain(cfg, statics, n_steps=151):
    """Kernel B == its plain version on every carry leaf from the initial
    carry and from mid-horizon, at an odd device count."""
    cfg = S.StepParams(*[x[:-1].contiguous() for x in cfg])
    carry = fleet.init_fleet(cfg, statics)
    for i0 in (0, 250):
        if i0:
            carry = fleet_step.fleet_fused_steps_plain(
                cfg, carry, 0, statics=statics, n_steps=i0)
        out = fleet_step.fleet_fused_steps(cfg, carry, i0, statics=statics,
                                           n_steps=n_steps)
        ref = fleet_step.fleet_fused_steps_plain(cfg, carry, i0,
                                                 statics=statics,
                                                 n_steps=n_steps)
        for f, a, b in zip(out._fields, out, ref):
            assert torch.equal(a, b), (i0, f)
        assert int(ref.m_units.sum()) > 0


@pytest.mark.parametrize("queue_size", [1, 3, 8])
def test_fleet_fused_kernel_queue_sizes(cuda, queue_size):
    """Two tasks at queue sizes 1, 3 and 8 (kernel instances QC = 3 and
    8), D = 79 devices over five blocks of 16, the last one part full."""
    cfg, statics = _replay_cfg_tasks(cuda, 2, queue_size, 5)
    _assert_fused_matches_plain(cfg, statics)


@pytest.mark.parametrize("queue_size", [3, 8])
def test_fleet_fused_kernel_eight_tasks(cuda, queue_size):
    """A synthetic set of K = 8 tasks (instance KC = 8), D = 47."""
    cfg, statics = _replay_cfg_tasks(cuda, 8, queue_size, 3)
    _assert_fused_matches_plain(cfg, statics)


def test_fleet_fused_kernel_keeps_a_nan_charge(cuda):
    """A unit of zero time drains ue * (dt / 0) = inf; a step that does not
    run charges 0 * inf = NaN, and the NaN stays in the energy as it does
    in the plain version (torch.minimum), every NaN in the same place."""
    cfg, statics = _replay_cfg_tasks(cuda, 2, 3, 2)
    ut = cfg.unit_time.clone()
    ut[:, 1, -1] = 0.0
    cfg = cfg._replace(unit_time=ut.contiguous())
    carry = fleet.init_fleet(cfg, statics)
    out = fleet_step.fleet_fused_steps(cfg, carry, 0, statics=statics,
                                       n_steps=statics.n_steps)
    ref = fleet_step.fleet_fused_steps_plain(cfg, carry, 0, statics=statics,
                                             n_steps=statics.n_steps)
    assert bool(ref.energy.isnan().any())
    for f, a, b in zip(out._fields, out, ref):
        if a.dtype.is_floating_point:
            assert torch.equal(a.isnan(), b.isnan()), f
            a, b = a.nan_to_num(), b.nan_to_num()
        assert torch.equal(a, b), f


def test_replay_modes_agree_and_launch_per_segment(cuda):
    """simulate_fleet in the three modes and run_segments (fused) agree on
    every result leaf; A launches once per step, B once per segment."""
    cfg, statics = _replay_cfg(cuda, 2)
    ops.reset_launch_counts()
    ref = fleet.simulate_fleet(cfg, statics, mode="vmap")
    assert ops.launch_counts()["fleet_priority"] == 0
    ker = fleet.simulate_fleet(cfg, statics, mode="pallas")
    assert ops.launch_counts()["fleet_priority"] == statics.n_steps
    fused = fleet.simulate_fleet(cfg, statics, mode="fused")
    assert ops.launch_counts()["fleet_fused_steps"] == 1
    seg, _ = fleet.run_segments(cfg, statics, 3, mode="fused")
    assert ops.launch_counts()["fleet_fused_steps"] == 4
    for other in (ker, fused, seg):
        for f, a, b in zip(ref._fields, ref, other):
            assert torch.equal(a, b), f
    assert int(ref.units_executed.sum()) > 0


def test_sweep_over_the_fleet_mesh_matches_unsharded(cuda):
    """``sweep(mesh=make_fleet_mesh())`` in pallas mode (every visible
    card, one block each) equals the sweep without a mesh on every result
    leaf, kernel A launching once per block per step; so does
    ``run_segments`` over the mesh with a hook that rewrites eta, which
    sees the device axis padded to the mesh size."""
    grid = _replay_grid(2)
    cfg, statics, meta = fleet.build(grid, cuda)
    mesh = make_fleet_mesh()
    ops.reset_launch_counts()
    res, _ = fleet.sweep(grid, mesh=mesh, mode="pallas", device=cuda)
    assert ops.launch_counts()["fleet_priority"] == (mesh.size
                                                     * statics.n_steps)
    plain, _ = fleet.sweep(grid, mode="pallas", device=cuda)
    for f, a, b in zip(plain._fields, plain, res):
        assert torch.equal(a, b), f
    seen = []

    def hook(seg, t_end, cfg, carry):
        seen.append(cfg.eta.shape[0])
        return cfg._replace(eta=torch.full_like(cfg.eta, 0.5 + 0.1 * seg))

    out = [fleet.run_segments(cfg, statics, 3, hook=hook, mesh=m,
                              mode="pallas") for m in (mesh, None)]
    for tree in range(2):
        for f, a, b in zip(out[0][tree]._fields, out[0][tree],
                           out[1][tree]):
            assert torch.equal(a, b), f
    pad = -(-len(meta) // mesh.size) * mesh.size
    assert seen == [pad] * 3 + [len(meta)] * 3


def test_forward_launches_flash_once_per_attention_layer(cuda):
    """``forward`` and ``anytime_forward`` on the card run every attention
    layer through kernel G, once each, and agree with the CPU's chunked
    path within rtol = atol = 1e-4 (f32; another algorithm and summation
    order)."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = TF.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    on_card = convert.tree(params, cuda)
    n0 = FA.launches
    logits = TF.forward(cfg, on_card, {"tokens": toks.to(cuda)})[0]
    torch.cuda.synchronize()
    assert FA.launches - n0 == cfg.n_layers
    heads = AT.init_heads(cfg, device=cuda)
    n0 = FA.launches
    rows = AT.anytime_forward(cfg, on_card, heads, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert FA.launches - n0 == cfg.n_layers
    assert torch.equal(rows[-1], logits)
    want = TF.forward(cfg, params, {"tokens": toks})[0]
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)


# kernel I shapes: (B, S, W, with h0): the JAX sweep's, its odd shape,
# ragged widths and a prefill-sized lane count
RGLRU_CASES = [(1, 8, 16, False), (4, 64, 96, True), (2, 100, 33, True),
               (8, 17, 128, False), (3, 37, 53, True), (1, 7, 1, True),
               (2, 300, 4096, False), (1, 1030, 4100, True)]


def test_rglru_scan_kernel_matches_plain(cuda):
    """Kernel I == its plain version bit for bit (both form ``a * h + b``
    with one rounding), one launch per call."""
    rng = np.random.default_rng(11)
    for B, S, W, with_h0 in RGLRU_CASES:
        a = rng.uniform(0.7, 0.999, (B, S, W)).astype(np.float32)
        b = (rng.normal(size=(B, S, W)) * 0.1).astype(np.float32)
        h0 = (rng.normal(size=(B, W)) if with_h0
              else np.zeros((B, W))).astype(np.float32)
        a, b, h0 = (torch.from_numpy(t).to(cuda) for t in (a, b, h0))
        n0 = RS.launches
        h, hl = RS.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        assert RS.launches == n0 + 1
        rh, rhl = RS.rglru_scan_plain(a, b, h0)
        assert torch.equal(h, rh) and torch.equal(hl, rhl), (B, S, W)


# kernel I on both copy paths: (B, S, W, offset, path): W = 4,096 and
# 4,100 on TMA, W = 53 and 33 and an input that starts one float into its
# storage on cp.async; S = 1, shorter than one step tile, one tile and one
# past it; B * W / 32 lane tiles below and above the card's 132 SMs
RGLRU_PATH_CASES = [
    (1, 100, 4096, 0, "tma"), (3, 70, 4096, 0, "tma"),
    (2, 33, 4100, 0, "tma"), (1, 1, 4096, 0, "tma"),
    (2, 17, 4096, 0, "tma"), (1, 32, 4096, 0, "tma"),
    (1, 300, 4100, 0, "tma"), (3, 129, 53, 0, "cp.async"),
    (2, 33, 33, 0, "cp.async"), (1, 100, 4096, 1, "cp.async"),
    (5, 1, 33, 0, "cp.async"), (1, 17, 4096, 1, "cp.async"),
    (9, 64, 4096, 1, "cp.async"),
]


@pytest.mark.parametrize("B,S,W,offset,path", RGLRU_PATH_CASES)
def test_rglru_scan_kernel_copy_paths(cuda, B, S, W, offset, path):
    """Kernel I == its plain version bit for bit on the copy path the host
    picks for the inputs, one launch per call."""
    rng = np.random.default_rng(S * W + offset)
    n = B * S * W

    def on_card(arr):
        flat = torch.zeros(n + offset, device=cuda)
        flat[offset:] = torch.from_numpy(arr.reshape(-1)).to(cuda)
        return flat[offset:].view(B, S, W)

    a = on_card(rng.uniform(0.7, 0.999, (B, S, W)).astype(np.float32))
    b = on_card((rng.normal(size=(B, S, W)) * 0.1).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(B, W)).astype(np.float32)).to(
        cuda)
    assert RS.copy_path(W, a.data_ptr(), b.data_ptr()) == path
    n0 = RS.launches
    h, hl = RS.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert RS.launches == n0 + 1
    rh, rhl = RS.rglru_scan_plain(a, b, h0)
    assert torch.equal(h, rh) and torch.equal(hl, rhl)


# kernel H shapes: (B, H, KV, hd, C, window); each runs in f32 and bf16,
# with and without round_p: recurrentgemma-9b's decode and engine batch,
# glm4-9b's geometry, qwen1.5-0.5b's, the JAX sweep's and a ragged cache;
# dbrx-132b's 48 heads on 8 (G = 6) and a G = 6 group under a window
DECODE_CASES = [(1, 16, 1, 256, 2176, 2048), (16, 16, 1, 256, 64, 2048),
                (1, 32, 2, 128, 4096, 16), (1, 16, 16, 64, 4160, 0),
                (4, 8, 2, 32, 128, 16), (5, 4, 2, 16, 37, 0),
                (3, 8, 8, 32, 96, 0), (3, 48, 8, 128, 300, 0),
                (2, 12, 2, 64, 100, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("round_p", [False, True])
def test_decode_gqa_kernel_matches_plain(cuda, dtype, round_p):
    """Kernel H against its plain version on the same inputs, one launch
    per call, at rtol = atol = 1e-5: the same f32 arithmetic, differing in
    the summation order of the dot products and the denominator.  Each
    batch has a row whose cache holds no valid slot."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    for B, H, KV, hd, C, window in DECODE_CASES:
        q = torch.randn((B, H, hd), generator=g, device=cuda).to(dt)
        k = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dt)
        v = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dt)
        pos = torch.randint(1, C + 1, (B,), generator=g, device=cuda)
        slots = torch.arange(C, device=cuda)
        slot_pos = torch.where(slots[None] < pos[:, None], slots[None], -1)
        if B > 1:
            slot_pos[-1] = -1                 # a row with no valid slot
        n0 = DG.launches
        out = DG.decode_gqa(q, k, v, slot_pos, pos - 1, window=window,
                            round_p=round_p)
        torch.cuda.synchronize()
        assert DG.launches == n0 + 1
        assert out.dtype == torch.float32 and bool(out.isfinite().all())
        want = DG.decode_gqa_plain(q, k, v, slot_pos, pos - 1,
                                   window=window, round_p=round_p)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{(B, H, KV, hd, C)}: {m}")


# kernel H with the cache split across blocks: (B, H, KV, hd, C, window);
# C spans several 64-slot chunks with a ragged last one, B * KV below 132
# (split) and at or above it (one chunk per pair)
DECODE_SPLIT_CASES = [(1, 16, 1, 256, 4097, 0), (2, 8, 2, 64, 1000, 300),
                      (3, 4, 1, 128, 129, 0), (1, 32, 8, 128, 2111, 64),
                      (20, 8, 8, 32, 300, 0), (70, 4, 2, 16, 200, 50)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("round_p", [False, True])
def test_decode_gqa_split_cache_matches_plain(cuda, dtype, round_p):
    """Kernel H where the split plan cuts the cache into chunks (and where
    ``B * KV`` fills the card and it does not), at rtol = atol = 1e-5
    against its plain version, one launch count per call.  The weights
    agree bit for bit whatever the split; only the PV order differs.  The
    last row of each batch sees no valid slot."""
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(7)
    for B, H, KV, hd, C, window in DECODE_SPLIT_CASES:
        nsplit, chunk = DG.split_plan(B, KV, C, sms)
        assert (nsplit > 1) == (B * KV < sms), (B, KV, C)
        assert (nsplit - 1) * chunk < C <= nsplit * chunk
        q = torch.randn((B, H, hd), generator=g, device=cuda).to(dt)
        k = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dt)
        v = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dt)
        pos = torch.randint(C // 2, C + 1, (B,), generator=g, device=cuda)
        slots = torch.arange(C, device=cuda)
        slot_pos = torch.where(slots[None] < pos[:, None], slots[None], -1)
        if B > 1:
            slot_pos[-1] = -1                 # a row with no valid slot
        n0 = DG.launches
        out = DG.decode_gqa(q, k, v, slot_pos, pos - 1, window=window,
                            round_p=round_p)
        torch.cuda.synchronize()
        assert DG.launches == n0 + 1
        assert bool(out.isfinite().all())
        want = DG.decode_gqa_plain(q, k, v, slot_pos, pos - 1,
                                   window=window, round_p=round_p)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{(B, H, KV, hd, C)}: {m}")


# kernel H's slice entries: (B, H, KV, hd, C, window) cut into n slices:
# the hybrid's decode and engine batch (its engine's 64-slot cache over a
# (1, 2) mesh, as chip_smoke.py runs it, and 4 ways), glm4-9b's 2 kv
# heads, a ragged last slice and a slice with no valid slot; the long cache
# at 2 and 4 cuts splits each slice into 17 and 9 chunks (the last one
# ragged at 4), 150-slot slices of two rows into 64 + 64 + 22, and hd = 36
# stages bf16 rows element by element (72 bytes: no 16-byte pieces)
SLICE_CASES = [(1, 16, 1, 256, 2176, 2048, 2), (16, 16, 1, 256, 64, 2048, 2),
               (16, 16, 1, 256, 64, 2048, 4),
               (1, 32, 2, 128, 4096, 16, 4), (3, 8, 2, 32, 100, 0, 3),
               (2, 12, 2, 64, 96, 16, 2), (1, 16, 1, 256, 2176, 2048, 4),
               (2, 8, 1, 64, 300, 0, 2), (2, 4, 2, 36, 130, 0, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gqa_slices_match_plain(cuda, dtype):
    """H's stats, merge and PV entries over a cache cut into slices, each
    against its plain version: the kept scores, the maxima and the merge
    bit for bit, the
    f64 sums to 1e-12, the PV sums at rtol = atol = 1e-5; the blocks' PV
    sums added in order are H on the whole cache within 1e-5 in f32 (the
    weights differ by the rounding of their denominator at most).  One
    launch count per entry call."""
    from repro_torch.models.common import block_sum

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(29)
    for B, H, KV, hd, C, window, n in SLICE_CASES:
        q = torch.randn((B, H, hd), generator=g, device=cuda).to(dt)
        k = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dt)
        v = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dt)
        pos = torch.randint(1, C + 1, (B,), generator=g, device=cuda)
        slots = torch.arange(C, device=cuda)
        slot_pos = torch.where(slots[None] < pos[:, None], slots[None], -1)
        pos = (pos - 1).to(torch.int32)
        cut = -(-C // n)
        bounds = [(i * cut, min(C, (i + 1) * cut)) for i in range(n)]
        ks, vs, sps = ([t[:, a:b].contiguous() for a, b in bounds]
                       for t in (k, v, slot_pos))
        n0 = (DG.stats_launches, DG.merge_launches, DG.pv_launches)
        stats = [DG.decode_gqa_stats(q, a, s, pos, window=window)
                 for a, s in zip(ks, sps)]
        for (m1, l1, s1), a, s in zip(stats, ks, sps):
            m2, l2, s2 = DG.decode_gqa_stats_plain(q, a, s, pos,
                                                   window=window)
            assert torch.equal(s1, s2) and torch.equal(m1, m2)
            torch.testing.assert_close(l1, l2, rtol=1e-12, atol=0)
        pm = torch.stack([x[0] for x in stats])
        ps = torch.stack([x[1] for x in stats])
        m, l = DG.decode_gqa_merge(pm, ps)
        m2, l2 = DG.decode_gqa_merge_plain(pm, ps)
        assert torch.equal(m, m2) and torch.equal(l, l2)
        pvs = [DG.decode_gqa_pv(x[2], b, m, l) for x, b in zip(stats, vs)]
        torch.cuda.synchronize()
        assert (DG.stats_launches, DG.merge_launches, DG.pv_launches) == (
            n0[0] + n, n0[1] + 1, n0[2] + n)
        for o, x, b in zip(pvs, stats, vs):
            want = DG.decode_gqa_pv_plain(x[2], b, m, l)
            torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-5)
        if dtype == "float32":
            whole = DG.decode_gqa(q, k, v, slot_pos, pos, window=window,
                                  round_p=True)
            torch.testing.assert_close(block_sum(pvs), whole, rtol=1e-5,
                                       atol=1e-5)


def test_centroid_partial_and_finish_match_plain(cuda):
    """E's partial entry on each of 4 blocks of rows (some rows assigned
    to no cluster, a cluster no block touches) and its finish of the
    blocks' summed partials, bit for bit against the plain versions; one
    block's partial and finish equal ``centroid_update`` bit for bit."""
    rng = np.random.default_rng(29)
    for k, d, B in ((5, 8192, 64), (8, 300, 4 * 700), (1, 64, 40)):
        c = torch.from_numpy(rng.normal(size=(k, d)).astype(
            np.float32)).to(cuda)
        x = torch.from_numpy(rng.normal(size=(B, d)).astype(
            np.float32)).to(cuda)
        a = rng.integers(-1, k, B).astype(np.int32)
        if k > 1:
            a[a == k - 1] = -1
        a = torch.from_numpy(a).to(cuda)
        parts = []
        for i in range(4):
            sl = slice(i * B // 4, (i + 1) * B // 4)
            got = CU.centroid_partial(x[sl], a[sl], k)
            want = CU.centroid_partial_plain(x[sl], a[sl], k)
            assert all(torch.equal(u, w) for u, w in zip(got, want))
            parts.append(got)
        sums = parts[0][0] + parts[1][0] + parts[2][0] + parts[3][0]
        n = parts[0][1] + parts[1][1] + parts[2][1] + parts[3][1]
        assert torch.equal(CU.centroid_finish(c, sums, n, 32.0),
                           CU.centroid_finish_plain(c, sums, n, 32.0))
        one = CU.centroid_finish(c, *CU.centroid_partial(x, a, k), 32.0)
        assert torch.equal(one, CU.centroid_update(c, x, a, 32.0))


@pytest.mark.parametrize("bank_mode,adapt", [("per-device", False),
                                             ("shared", True)])
def test_serve_scan_over_four_blocks_of_one_card_matches_cpu(
        cuda, bank_mode, adapt):
    """``FleetServeEngine.run`` over ``make_fleet_mesh(4, "cuda:0")`` (8
    devices, two per block; kernel D per block and step, E's partial entry
    per block) against the same mesh run on the CPU from the card's build
    and the same models: every leaf bit for bit without adaptation; with
    the shared bank adapting, every integer leaf, the float leaves within
    1e-4 (the propagation convs are cuDNN's on the card)."""
    from repro_torch.core.agile import AgileCNN

    eng, reqs = _engine(cuda, adapt, bank_mode)
    built = eng.build(reqs, 8, seeds=range(8))
    eng.build = lambda *a, **k: built
    ops.reset_launch_counts()
    card = eng.run(reqs, 8, mesh=make_fleet_mesh(4, device="cuda:0"))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["l1_topk2"] == 4 * built[1].n_steps
    if adapt:
        assert counts["centroid_finish"] > 0
        assert counts["centroid_partial"] == 4 * counts["centroid_finish"]
        assert counts["centroid_update"] == 0

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
            return type(tree)(cpu(v) for v in tree)
        if hasattr(tree, "_fields"):
            return type(tree)(*[cpu(v) for v in tree])
        return tree.cpu() if isinstance(tree, torch.Tensor) else tree

    models = [AgileCNN(m.cfg, cpu(m.params), [cpu(uc) for uc in m.bank])
              for m in eng.models]
    ref_eng = FleetServeEngine(models, eng.harvester, eng.eta,
                               config=eng.config, bank_mode=bank_mode,
                               device="cpu")
    ref_eng.build = lambda *a, **k: cpu(built)
    ref = ref_eng.run(reqs, 8, mesh=make_fleet_mesh(4, device="cpu"))
    for part in ("dev", "bank", "log"):
        a_p, b_p = getattr(card.carry, part), getattr(ref.carry, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            if adapt and a.dtype.is_floating_point:
                torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
            else:
                assert torch.equal(a.cpu(), b), f"{part}.{f}"


def test_decode_gqa_counts_one_launch_per_call(cuda):
    """One ``decode_gqa`` call adds exactly one to ``launches``, whether the
    kernel runs as one launch (no split) or four (a split cache)."""
    for B, C in ((16, 64), (1, 2176)):
        q = torch.randn((B, 16, 256), device=cuda).bfloat16()
        kv = torch.randn((B, C, 1, 256), device=cuda).bfloat16()
        slot_pos = torch.arange(C, device=cuda).expand(B, C).contiguous()
        pos = torch.full((B,), C - 1, device=cuda)
        n0 = DG.launches
        DG.decode_gqa(q, kv, kv, slot_pos, pos, round_p=True)
        torch.cuda.synchronize()
        assert DG.launches == n0 + 1


def _assert_window_fits_chunk(cfg, S):
    """The card-vs-CPU checks hold only on windows that are multiples of
    the CPU path's chunk (``attention.chunk_size``): on any other window
    the reference's chunked path, which the CPU port mirrors, drops keys
    from the first rows of each query chunk that kernel G keeps."""
    chunk = PA.chunk_size(S, S, cfg.attn_chunk)
    assert cfg.window % chunk == 0, (cfg.window, chunk)


def _hybrid(cuda):
    cfg = get_config("recurrentgemma-9b").reduced()
    params = TF.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params, convert.tree(params, cuda)


def test_hybrid_forward_launches_rglru_and_flash_per_layer(cuda):
    """The reduced recurrentgemma-9b's ``forward`` and ``anytime_forward``
    on the card launch kernel I once per recurrent layer and kernel G once
    per attention layer, and agree with the CPU's path (associative scan,
    chunked attention) within rtol = atol = 1e-4, on a window that is a
    multiple of the CPU path's chunk (asserted)."""
    cfg, params, on_card = _hybrid(cuda)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)).astype(np.int32))
    _assert_window_fits_chunk(cfg, 128)
    ops.reset_launch_counts()
    logits = TF.forward(cfg, on_card, {"tokens": toks.to(cuda)})[0]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == kinds.count("rec") == 2
    assert counts["flash_attention"] == kinds.count("attn") == 1
    heads = AT.init_heads(cfg, device=cuda)
    rows = AT.anytime_forward(cfg, on_card, heads, {"tokens": toks.to(cuda)})
    assert torch.equal(rows[-1], logits)
    want = TF.forward(cfg, params, {"tokens": toks})[0]
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)


def test_hybrid_decode_step_launches_decode_gqa_per_attention_layer(cuda):
    """A prefill and ``decode_step``s of the reduced hybrid on the card:
    each step launches kernel H once per attention layer and no scan; the
    logits and the recurrent state agree with the CPU within 1e-4."""
    cfg, params, on_card = _hybrid(cuda)
    _assert_window_fits_chunk(cfg, 64)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    la, sa = TF.prefill(cfg, on_card, {"tokens": toks.to(cuda)})
    lb, sb = TF.prefill(cfg, params, {"tokens": toks})
    for step in range(3):
        tok = torch.argmax(lb, -1).to(torch.int32)
        ops.reset_launch_counts()
        la, sa = TF.decode_step(cfg, on_card, sa, tok.to(cuda))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["decode_gqa"] == 1 and counts["rglru_scan"] == 0
        lb, sb = TF.decode_step(cfg, params, sb, tok)
        torch.testing.assert_close(la.cpu(), lb, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sa["stack"][0]["h"].cpu(), sb["stack"][0]["h"],
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# The scalar engine's one-row kernels, the stream, scalar == fleet.
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("d,k", [(150, 5), (150, 2), (33, 5), (1100, 3)])
def test_l1_topk2_kernel_one_row_matches_plain(cuda, d, k):
    """Kernel D at the scalar engine's shape: one request's selected
    features against one unit's centroids."""
    rng = np.random.default_rng(d + k)
    x = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(cuda)
    n0 = L1.launches
    out = L1.l1_topk2(x, c)
    torch.cuda.synchronize()
    assert L1.launches == n0 + 1
    for a, b in zip(out, L1.l1_topk2_plain(x, c)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [8192, 4096, 384, 192, 33])
def test_centroid_update_kernel_one_row_matches_plain(cuda, d):
    """Kernel E at the scalar engine's adaptation: one row assigned to one
    of k = 5 centroids."""
    rng = np.random.default_rng(d)
    c = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32)).to(cuda)
    for j in range(5):
        a = torch.tensor([j], dtype=torch.int32, device=cuda)
        out = CU.centroid_update(c, x, a, 32.0)
        torch.cuda.synchronize()
        assert torch.equal(out, CU.centroid_update_plain(c, x, a, 32.0))


def _stream_engine(device, bank_mode, total):
    """``_engine``'s two tasks with a horizon for ``total`` jobs each."""
    eng, reqs = _engine(device, False, bank_mode)
    eng.config = dataclasses.replace(eng.config,
                                     horizon=total * eng.config.period + 2.0)
    return eng, reqs


@pytest.mark.parametrize("per_dev_tables", [False, True])
@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_serve_fused_kernel_on_stream_windows(cuda, bank_mode,
                                              per_dev_tables):
    """Kernel C == plain on a stream's staged windows (W < total jobs): the
    first chunk, whose ``job0`` is negative, and a middle chunk, whose
    ``job0`` is positive; the carry between them advanced by the kernel."""
    total, D = 12, 5
    eng, reqs = _stream_engine(cuda, bank_mode, total)
    if per_dev_tables:
        rng = np.random.default_rng(5)
        reqs = [[[Request(t[j].x, t[j].label, release=2.0 * i)
                  for i, j in enumerate(rng.permutation(len(t)))]
                 for t in reqs] for _ in range(D)]
        build = eng.build_stream(reqs, total_jobs=total)
    else:
        build = eng.build_stream(reqs, D, seeds=range(D), total_jobs=total)
    cfg, st, base, dev0, bank0, per_dev, _, base_len = build
    assert per_dev == per_dev_tables
    W, n, chunks = eng._stream_chunks(cfg, st, base, base_len, 4)
    mid = n // 2
    assert W < total
    carry = ServeCarry(dev=dev0, bank=bank0, log=eng.log0(D, W))
    for c, ch in enumerate(chunks):
        if c > mid:
            break
        if c == 0:
            assert (ch.w0 < 0).all()        # a negative job0
        if c == mid:
            assert (ch.w0 > 0).all()        # a positive job0
        assert (ch.tables.sel_feats.dim() == 5) == per_dev_tables
        carry = carry._replace(log=_shift_log(carry.log, ch.shift))
        out = fleet_step.serve_fused_steps(cfg, carry, ch.tables, ch.s0,
                                           ch.job0, statics=st,
                                           n_steps=ch.s1 - ch.s0)
        torch.cuda.synchronize()
        if c in (0, mid):
            ref = fleet_step.serve_fused_steps_plain(
                cfg, carry, ch.tables, ch.s0, ch.job0, statics=st,
                n_steps=ch.s1 - ch.s0)
            for part in ("dev", "log"):
                _leaves_equal(getattr(out, part), getattr(ref, part),
                              f"chunk {c} {part}")
        carry = out
    assert bool(carry.log.units.any())


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_fused_stream_matches_monolithic_on_card(cuda, bank_mode):
    """The fused stream on the card (one launch of kernel C per chunk) ==
    the monolithic fused run over the repeated request list."""
    total, D = 12, 5
    eng, reqs = _stream_engine(cuda, bank_mode, total)
    n_base = len(reqs[0])
    repeated = [[Request(t[j % n_base].x, t[j % n_base].label,
                         release=2.0 * j) for j in range(total)]
                for t in reqs]
    n0 = fleet_step.serve_launches
    st = eng.run_stream(reqs, D, seeds=range(D), total_jobs=total,
                        n_chunks=4, mode="fused")
    assert fleet_step.serve_launches == n0 + st.n_chunks == n0 + 4
    assert st.peak_bytes > 0 and st.chunk_table_bytes > 0
    mono = eng.run(repeated, D, seeds=range(D), mode="fused")
    for f in ("units", "pred", "correct", "margin", "exit_unit", "sched"):
        np.testing.assert_array_equal(getattr(st, f), getattr(mono, f),
                                      err_msg=f)
    for part in ("dev", "bank"):
        _leaves_equal(getattr(st.carry, part), getattr(mono.carry, part),
                      part)


def _one_task_model(device, threshold):
    """``_engine``'s first narrow CNN as one task, its bank's thresholds
    replaced by ``threshold`` (None keeps them)."""
    eng, reqs = _engine(device, False, "per-device", n_tasks=1)
    m = eng.models[0]
    bank = [uc if threshold is None else uc._replace(
        threshold=torch.full((), threshold, device=device)) for uc in m.bank]
    return (lambda: AgileCNN(m.cfg, m.params, list(bank))), reqs[0]


@pytest.mark.parametrize("policy", ["zygarde", "edf"])
@pytest.mark.parametrize("adapt", [False, True])
def test_scalar_engine_matches_fleet_on_card(cuda, policy, adapt):
    """The scalar engine on the card (kernels D and E one row at a time) ==
    the one-device fleet (``feature_batch=1``) bit for bit on the
    clock-commensurate recipe: units, schedule, predictions, margins."""
    make, reqs = _one_task_model(cuda, 0.02)
    n = len(reqs)
    cfg = ServeConfig(policy=policy, period=2.0, deadline=1.5,
                      horizon=n * 2.0 + 2.0, adapt=adapt, start_charged=True,
                      sim_dt=0.05)
    supply = energy.Harvester("battery", 1.0, 0.0, 1.0)
    ops.reset_launch_counts()
    eng = ServeEngine([make()], supply, eta=1.0, config=cfg)
    res = eng.run([reqs])
    counts = ops.launch_counts()
    profs = eng.profiles_[0]
    assert counts["l1_topk2"] == sum(p._exec_units for p in profs) > 0
    assert (counts["centroid_update"] > 0) == adapt
    units = np.array([j.unit for j in eng.jobs_])
    sched = np.array([0 <= j.mandatory_done_time <= j.deadline
                      for j in eng.jobs_])
    pred = np.array([p._preds[u - 1] if u > 0 else -1
                     for p, u in zip(profs, units)])
    margin = np.array([p._margins[u - 1] if u > 0 else 0.0
                       for p, u in zip(profs, units)], np.float32)
    f = FleetServeEngine([make()], supply, eta=1.0, config=cfg,
                         feature_batch=1, device=cuda).run([reqs], 1)
    np.testing.assert_array_equal(units, f.units[0, 0, :n])
    np.testing.assert_array_equal(sched, f.sched[0, 0, :n])
    np.testing.assert_array_equal(pred, f.pred[0, 0, :n])
    np.testing.assert_array_equal(margin.view(np.uint32),
                                  f.margin[0, 0, :n].view(np.uint32))
    assert res.units_executed == int(f.fleet.units_executed[0])
    assert res.scheduled == int(f.fleet.scheduled[0])


# --------------------------------------------------------------------- #
# Telemetry on the card (host-side and PyTorch-level code around kernels
# A, D and E): the card's telemetry == the CPU's, pallas == vmap.
# --------------------------------------------------------------------- #

TEL_INT = ("c_release", "c_miss", "c_sched", "c_retired", "c_power_fail",
           "c_reboot", "c_knob", "exit_hist", "occ_sum", "occ_max",
           "n_steps", "ring_kind", "ring_head")


def _tel_close(card, cpu_tel):
    """Integer fields exact, floats at tests/test_telemetry.py's
    tolerances."""
    for f in card._fields:
        a, b = getattr(card, f).cpu(), getattr(cpu_tel, f)
        assert a.dtype == b.dtype and a.device.type == "cpu", f
        if f in TEL_INT:
            assert torch.equal(a, b), f
        else:
            tol = 1e-4 if f in ("slack_sum", "energy_sum", "ring_val") \
                else 1e-6
            torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=f)


@pytest.mark.parametrize("level", ["counters", "full"])
def test_replay_telemetry_on_card_matches_cpu(cuda, level):
    """run_segments(telemetry=) in three segments on the card: the carry
    equals the CPU's bit for bit, the telemetry equals the CPU's, pallas
    (kernel A once per step) equals vmap on every telemetry field bit for
    bit, and the fields stay on the card."""
    from repro_torch import telemetry as TEL

    tcfg = TEL.TelemetryConfig(ring_size=8, level=level)
    cfg, statics = _replay_cfg(cuda, 2)
    cfg_cpu = type(cfg)(*[x.cpu() for x in cfg])
    ops.reset_launch_counts()
    _, c_vmap, t_vmap = fleet.run_segments(cfg, statics, 3, telemetry=tcfg)
    _, c_pallas, t_pallas = fleet.run_segments(cfg, statics, 3,
                                               telemetry=tcfg,
                                               mode="pallas")
    assert ops.launch_counts()["fleet_priority"] == statics.n_steps
    _, c_cpu, t_cpu = fleet.run_segments(cfg_cpu, statics, 3, telemetry=tcfg)
    for f in t_vmap._fields:
        assert getattr(t_vmap, f).device.type == "cuda", f
        assert torch.equal(getattr(t_vmap, f), getattr(t_pallas, f)), f
    for f, a, b in zip(c_vmap._fields, c_vmap, c_cpu):
        assert torch.equal(a.cpu(), b), f
        assert torch.equal(a, getattr(c_pallas, f)), f
    _tel_close(t_vmap, t_cpu)
    assert int(t_vmap.c_power_fail.sum()) > 0


def test_serve_telemetry_on_card_matches_cpu(cuda):
    """The serve scan with telemetry=full from the same built state on the
    card (kernel D) and on the CPU: the carry bit-equal, the telemetry
    equal; a second run at counters equals run_stream's in 3 chunks."""
    from repro_torch import telemetry as TEL

    eng, reqs = _engine(cuda, False, "per-device")
    cfg, statics, tables, carry0, _ = eng.build(reqs, 4, seeds=range(4))
    full = TEL.TelemetryConfig(ring_size=8, level="full")

    def cpu(tree):
        return type(tree)(*[cpu(v) if isinstance(v, tuple) else v.cpu()
                            for v in tree])

    outs = []
    for c, t, k in ((cfg, tables, carry0), (cpu(cfg), cpu(tables),
                                           cpu(carry0))):
        outs.append(eng._scan_steps(
            c, t, k, 0, statics=statics, n_steps=statics.n_steps,
            adapt=False, tel=TEL.init_fleet_telemetry(full, c), tcfg=full))
    (card, t_card), (on_cpu, t_cpu) = outs
    for part in ("dev", "log"):
        a_p, b_p = getattr(card, part), getattr(on_cpu, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            assert torch.equal(a.cpu(), b), f"{part}.{f}"
    _tel_close(t_card, t_cpu)
    assert t_card.ring_t.device.type == "cuda"
    counters = TEL.TelemetryConfig(level="counters")
    run = eng.run(reqs, 4, seeds=range(4), n_segments=3, telemetry=counters)
    st = eng.run_stream(reqs, 4, seeds=range(4), n_chunks=3,
                        telemetry=counters)
    for f in run.telemetry._fields:
        assert torch.equal(getattr(run.telemetry, f),
                           getattr(st.telemetry, f)), f


# the rest of the model zoo at its reduced sizes: (arch, kernel G launches
# of one forward): an attention layer each, and for the encoder-decoder its
# encoder layers and a cross-attention per decoder layer too
ZOO_CASES = [("dbrx-132b", 2), ("qwen3-moe-235b-a22b", 2), ("xlstm-125m", 0),
             ("seamless-m4t-medium", 6), ("internvl2-2b", 2)]


@pytest.mark.parametrize("arch,n_flash", ZOO_CASES)
def test_zoo_forward_on_card_matches_cpu(cuda, arch, n_flash):
    """Each family's reduced ``forward`` (the MoE FFN, the xLSTM cells, the
    encoder over stub frames with cross-attention, the VLM's prepended
    patches) on the card against the CPU within rtol = atol = 1e-4 (f32;
    kernel G against the CPU's dense or chunked path), the MoE aux loss
    too, with kernel G launched as counted; then a prefill and two decode
    steps, kernel H once per attention and cross-attention layer."""
    cfg = get_config(arch).reduced()
    params = TF.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    on_card = convert.tree(params, cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))}
    n_front = cfg.n_enc_tokens or cfg.n_frontend_tokens
    if n_front:
        batch["frontend"] = torch.from_numpy(rng.normal(
            size=(2, n_front, cfg.d_model)).astype(np.float32))
    dev_batch = {k: v.to(cuda) for k, v in batch.items()}
    n0 = FA.launches
    logits, aux = TF.forward(cfg, on_card, dev_batch)
    torch.cuda.synchronize()
    assert FA.launches - n0 == n_flash
    want, want_aux = TF.forward(cfg, params, batch)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)
    la, sa = TF.prefill(cfg, on_card, dev_batch, cache_len=96)
    lb, sb = TF.prefill(cfg, params, batch, cache_len=96)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    per_step = kinds.count("attn") * (2 if cfg.is_encoder_decoder else 1)
    for _ in range(2):
        torch.testing.assert_close(la.cpu(), lb, rtol=1e-4, atol=1e-4)
        tok = torch.argmax(lb, -1).to(torch.int32)
        n0 = DG.launches
        la, sa = TF.decode_step(cfg, on_card, sa, tok.to(cuda))
        torch.cuda.synchronize()
        assert DG.launches - n0 == per_step
        lb, sb = TF.decode_step(cfg, params, sb, tok)
    torch.testing.assert_close(la.cpu(), lb, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# Training: the backward kernels of G and I, and the train step.
# --------------------------------------------------------------------------- #

# (B, S, Skv, H, KV, hd, causal, window, q_offset): qwen1.5-0.5b's layer at
# 4,096 tokens, dbrx-132b's 48 heads on 8 at hd 128, recurrentgemma-9b's
# window of 2,048 at 4,096 (MQA, hd 256), a non-causal S != Skv row with a
# query offset (cross-attention's shape class), then ragged lengths,
# groups of 6 and 64, hd 80 and a window that is no multiple of a tile;
# then hd 256 with G = 6 (ten positions a row tile, four padding rows)
# under ragged windows, causal and not
FLASH_BWD_CASES = [
    (1, 4096, 4096, 16, 16, 64, True, 0, 0),
    (1, 1024, 1024, 48, 8, 128, True, 0, 0),
    (1, 4096, 4096, 16, 1, 256, True, 2048, 0),
    (1, 512, 1024, 16, 16, 64, False, 0, 512),
    (2, 37, 37, 12, 2, 32, True, 0, 0),
    (1, 33, 33, 64, 1, 16, True, 0, 0),
    (2, 90, 200, 6, 1, 80, False, 0, 0),
    (1, 300, 300, 4, 2, 64, True, 70, 0),
    (1, 301, 301, 12, 2, 256, True, 70, 0),
    # rows that see no key: causal positions before key 0 and window
    # positions past the last (Skv 130: the forward's mean over 256)
    (1, 200, 130, 8, 2, 64, True, 20, -40),
    (1, 4096, 4096, 32, 32, 80, True, 0, 0),   # stablelm-3b: hd 80, MHA
    (2, 150, 203, 6, 1, 256, False, 45, 30),
]


def _flash_bwd_inputs(case, dt, g, device):
    B, S, Skv, H, KV, hd, causal, window, qo = case
    q = torch.randn((B, S, H, hd), generator=g, device=device).to(dt)
    k = torch.randn((B, Skv, KV, hd), generator=g, device=device).to(dt)
    v = torch.randn((B, Skv, KV, hd), generator=g, device=device).to(dt)
    dout = torch.randn((B, S, H, hd), generator=g, device=device)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, case, dtype):
    """G's backward kernels against the plain backward on the forward's
    own ``out`` and ``lse``: each gradient within 1e-4 of its largest value
    in f32 (both sum in f32, in other orders) and within 2^-7 in bf16 (the
    results rounded to bf16), one counted call of two launches."""
    B, S, Skv, H, KV, hd, causal, window, qo = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, dout = _flash_bwd_inputs(case, dt, g, cuda)
    kw = dict(causal=causal, window=window, q_offset=qo)
    out, lse = FA._launch(q, k, v, causal, window, qo, True)
    n0 = FA.bwd_launches
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert FA.bwd_launches == n0 + 2
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dt and bool(a.isfinite().all())
        gap = float((a.float() - b.float()).abs().max())
        top = float(b.float().abs().max())
        assert gap <= tol * top, (case, dtype, "d" + name, gap, top)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [FLASH_BWD_CASES[1], FLASH_BWD_CASES[-1]])
def test_flash_attention_bwd_is_deterministic(cuda, case, dtype):
    """Two calls of G's backward on the same inputs give the same bits (no
    float atomics, a fixed summation order)."""
    B, S, Skv, H, KV, hd, causal, window, qo = case
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v, dout = _flash_bwd_inputs(case, getattr(torch, dtype), g, cuda)
    kw = dict(causal=causal, window=window, q_offset=qo)
    out, lse = FA._launch(q, k, v, causal, window, qo, True)
    first = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_lse_leaves_out_unchanged(cuda, dtype):
    """The forward with its log-sum-exp output gives ``out`` bit for bit as
    the serving launch does, and ``lse`` within 1e-5 of the plain one."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(12)
    for case in FLASH_BWD_CASES:
        B, S, Skv, H, KV, hd, causal, window, qo = case
        q, k, v, _ = _flash_bwd_inputs(case, dt, g, cuda)
        plain_out = FA._launch(q, k, v, causal, window, qo, False)[0]
        out, lse = FA._launch(q, k, v, causal, window, qo, True)
        assert torch.equal(out, plain_out)
        _, want = FA.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, q_offset=qo,
                                           return_lse=True)
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_autograd_launches_the_backward(cuda):
    """Under autograd the wrapper runs the Function: one forward launch,
    one backward call of two launches, gradients equal to the backward
    wrapper's; under ``no_grad`` nothing but the serving launch."""
    case = (1, 130, 130, 8, 2, 64, True, 0, 0)
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v, dout = _flash_bwd_inputs(case, torch.bfloat16, g, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = FA.launches, FA.bwd_launches
    out = FA.flash_attention(*leaves)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (FA.launches - f0, FA.bwd_launches - b0) == (1, 2)
    o2, lse = FA._launch(q, k, v, True, 0, 0, True)
    want = FA.flash_attention_bwd(q, k, v, o2, lse, dout)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    n_bwd = FA.bwd_launches
    with torch.no_grad():
        FA.flash_attention(*leaves)
    assert FA.bwd_launches == n_bwd


RGLRU_BWD_CASES = [(1, 4096, 4096), (2, 512, 4096), (3, 37, 53), (1, 7, 5)]


@pytest.mark.parametrize("B,S,W", RGLRU_BWD_CASES)
def test_rglru_scan_bwd_kernel_bit_equal(cuda, B, S, W):
    """I's backward kernel against the plain reverse chain, bit for bit
    (every product and sum one f32 rounding in both)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    a = 0.7 + 0.299 * torch.rand((B, S, W), generator=g, device=cuda)
    b = 0.1 * torch.randn((B, S, W), generator=g, device=cuda)
    h0 = torch.randn((B, W), generator=g, device=cuda)
    dh = torch.randn((B, S, W), generator=g, device=cuda)
    h, _ = RS.rglru_scan(a, b, h0)
    n0 = RS.bwd_launches
    got = RS.rglru_scan_bwd(a, h0, h, dh)
    torch.cuda.synchronize()
    assert RS.bwd_launches == n0 + 1
    want = RS.rglru_scan_bwd_plain(a, h0, h, dh)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("B,S,W,offset,path", RGLRU_PATH_CASES)
def test_rglru_scan_bwd_kernel_copy_paths(cuda, B, S, W, offset, path):
    """I's backward kernel == its plain version bit for bit on the copy
    path the host picks (TMA, or cp.async for a ragged W or inputs off 16
    bytes), with S a multiple of the step tile or not, one launch per
    call."""
    rng = np.random.default_rng(S * W + offset + 1)
    n = B * S * W

    def on_card(arr):
        flat = torch.zeros(n + offset, device=cuda)
        flat[offset:] = torch.from_numpy(arr.reshape(-1)).to(cuda)
        return flat[offset:].view(B, S, W)

    a = on_card(rng.uniform(0.7, 0.999, (B, S, W)).astype(np.float32))
    h = on_card(rng.normal(size=(B, S, W)).astype(np.float32))
    dh = on_card(rng.normal(size=(B, S, W)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(B, W)).astype(np.float32)).to(
        cuda)
    assert RS.copy_path(W, a.data_ptr(), h.data_ptr(), dh.data_ptr()) == path
    n0 = RS.bwd_launches
    got = RS.rglru_scan_bwd(a, h0, h, dh)
    torch.cuda.synchronize()
    assert RS.bwd_launches == n0 + 1
    want = RS.rglru_scan_bwd_plain(a, h0, h, dh)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_rglru_scan_autograd_launches_the_backward(cuda):
    g = torch.Generator(device=cuda).manual_seed(15)
    a = (0.7 + 0.299 * torch.rand((2, 40, 33), generator=g, device=cuda))
    b = 0.1 * torch.randn((2, 40, 33), generator=g, device=cuda)
    h0 = torch.randn((2, 33), generator=g, device=cuda)
    dh = torch.randn((2, 40, 33), generator=g, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)]
    b0 = RS.bwd_launches
    h, last = RS.rglru_scan(*leaves)
    (h * dh).sum().backward()
    assert RS.bwd_launches - b0 == 1
    want = RS.rglru_scan_bwd(a, h0, RS.rglru_scan(a, b, h0)[0], dh)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_decode_gqa_raises_under_grad(cuda):
    """Kernel H has no backward: under autograd with an input that needs a
    gradient it raises instead of returning a tensor without a graph."""
    q = torch.randn((1, 4, 16), device=cuda, requires_grad=True)
    kc = torch.randn((1, 8, 2, 16), device=cuda)
    slot = torch.arange(8, device=cuda, dtype=torch.int32)[None]
    pos = torch.tensor([7], device=cuda, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        DG.decode_gqa(q, kc, kc, slot, pos)
    with torch.no_grad():
        assert DG.decode_gqa(q, kc, kc, slot, pos).shape == (1, 4, 16)


TRAIN_FAMILIES = ("qwen1.5-0.5b", "recurrentgemma-9b", "dbrx-132b",
                  "xlstm-125m", "seamless-m4t-medium", "internvl2-2b")


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One reduced LM step per family on the card against the CPU from the
    same parameters and batch (f32): loss and aux within 1e-4, every
    gradient leaf within 1e-4 of that leaf's largest, or of 1e-3 of the
    model's largest if that is more (a leaf under it is rounding noise, as
    the sLSTM's input-gate bias; kernels G and I and their backward
    kernels on the card, the plain paths on the CPU)."""
    from repro_torch.train import trainer as TR
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(arch).reduced()
    params = TF.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))}
    n_front = cfg.n_enc_tokens or cfg.n_frontend_tokens
    if n_front:
        batch["frontend"] = torch.from_numpy(rng.normal(
            size=(2, n_front, cfg.d_model)).astype(np.float32))
    b0 = (FA.bwd_launches, RS.bwd_launches)
    g_card, m_card = TR.lm_grads(cfg, convert.tree(params, cuda),
                                 {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    if "attn" in kinds:
        assert FA.bwd_launches > b0[0]
    if "rec" in kinds:
        assert RS.bwd_launches > b0[1]
    g_cpu, m_cpu = TR.lm_grads(cfg, params, batch)
    for key in ("loss", "aux"):
        torch.testing.assert_close(m_card[key].cpu(), m_cpu[key], rtol=1e-4,
                                   atol=1e-4)
    top = max(float(b.abs().max()) for b in tree_leaves(g_cpu))
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        gap = float((a.cpu() - b).abs().max())
        assert gap <= 1e-4 * max(float(b.abs().max()), 1e-3 * top), (arch,
                                                                      gap)


def test_remat_gradients_agree_on_the_card(cuda):
    """The LM loss's gradients of reduced stablelm-3b (6 layers: a
    checkpointed group of 4 and a leftover of 2) through ``forward`` with
    and without ``remat`` on the card: every leaf within 1e-4 of that
    leaf's largest, or of 1e-3 of the model's largest if that is more (the
    train tests' tolerance); with ``remat`` each layer's forward kernel
    launches twice, without once."""
    import dataclasses

    from repro_torch.core import losses
    from repro_torch.train.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("stablelm-3b").reduced(),
                              n_layers=6)
    params = TF.init_params(cfg, torch.Generator(device=cuda).manual_seed(2),
                            device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)).to(cuda)

    def grads(remat):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits, _ = TF.forward(cfg, live, {"tokens": tokens}, remat=remat)
        loss = losses.lm_loss(logits, tokens)
        return torch.autograd.grad(loss, tree_leaves(live))

    f0 = FA.launches
    a = grads(True)
    torch.cuda.synchronize()
    f1 = FA.launches
    b = grads(False)
    torch.cuda.synchronize()
    assert (f1 - f0, FA.launches - f1) == (12, 6)
    top = max(float(y.abs().max()) for y in b)
    for x, y in zip(a, b):
        gap = float((x - y).abs().max())
        assert gap <= 1e-4 * max(float(y.abs().max()), 1e-3 * top), gap


def _one_call(name, cuda):
    """One call of kernel ``name``'s public entry point on the card, as a
    thunk."""
    rng = np.random.default_rng(11)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda, dtype)

    if name == "fleet_priority":
        ins = _priority_operands(cuda, 40, 3)
        args = tuple(ins[f] for f in (
            "policy", "active", "laxity", "release", "utility", "mandatory",
            "alpha", "beta", "eta", "persistent", "energy", "e_opt", "power",
            "capacity", "gate_e", "drain", "forced", "task", "rr_cursor"))
        return lambda: FP.fleet_priority(*args, n_tasks=2, dt=0.01)
    if name == "fleet_fused_steps":
        cfg, statics = _replay_cfg(cuda, 1)
        carry = fleet.init_fleet(cfg, statics)
        return lambda: fleet_step.fleet_fused_steps(
            cfg, carry, 0, statics=statics, n_steps=statics.n_steps)
    if name == "serve_fused_steps":
        eng, reqs = _engine(cuda, False, "per-device")
        return lambda: eng.run(reqs, 5, seeds=range(5), n_segments=1,
                               mode="fused")
    if name == "l1_topk2":
        x, c = t(9, 150), t(9, 5, 150)
        return lambda: L1.l1_topk2(x, c)
    if name == "centroid_update":
        c, x = t(5, 64), t(12, 64)
        a = torch.tensor([0, -1, 3, 4, -1, 2, 2, 0, 1, -1, 4, 4],
                         dtype=torch.int32, device=cuda)
        return lambda: CU.centroid_update(c, x, a, 32.0)
    if name == "pairwise_l1":
        x, y = t(33, 6), t(17, 6)
        return lambda: PW.pairwise_l1(x, y)
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k, v = (t(1, 96, 4, 64, dtype=torch.bfloat16),
                   t(1, 96, 2, 64, dtype=torch.bfloat16),
                   t(1, 96, 2, 64, dtype=torch.bfloat16))
        if name == "flash_attention":
            return lambda: FA.flash_attention(q, k, v)
        out, lse = FA._launch(q, k, v, True, 0, 0, True)
        dout = t(1, 96, 4, 64)
        return lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout)
    if name == "decode_gqa":
        q, kc, vc = t(2, 8, 64), t(2, 40, 2, 64), t(2, 40, 2, 64)
        slot_pos = torch.arange(40, dtype=torch.int32,
                                device=cuda).expand(2, 40).contiguous()
        pos = torch.tensor([39, 20], dtype=torch.int32, device=cuda)
        return lambda: DG.decode_gqa(q, kc, vc, slot_pos, pos, window=16)
    if name in ("decode_gqa_stats", "decode_gqa_merge", "decode_gqa_pv"):
        q, kc, vc = t(2, 8, 64), t(2, 24, 2, 64), t(2, 24, 2, 64)
        slot_pos = torch.arange(24, dtype=torch.int32,
                                device=cuda).expand(2, 24).contiguous()
        pos = torch.tensor([23, 10], dtype=torch.int32, device=cuda)
        if name == "decode_gqa_stats":
            return lambda: DG.decode_gqa_stats(q, kc, slot_pos, pos)
        m, l, sc = DG.decode_gqa_stats_plain(q, kc, slot_pos, pos)
        if name == "decode_gqa_merge":
            pm, ps = torch.stack([m, m - 1.0]), torch.stack([l, 2 * l])
            return lambda: DG.decode_gqa_merge(pm, ps)
        return lambda: DG.decode_gqa_pv(sc, vc, m, l.float())
    if name in ("centroid_partial", "centroid_finish"):
        c, x = t(5, 64), t(12, 64)
        a = torch.tensor([0, -1, 3, 4, -1, 2, 2, 0, 1, -1, 4, 4],
                         dtype=torch.int32, device=cuda)
        if name == "centroid_partial":
            return lambda: CU.centroid_partial(x, a, 5)
        sums, n = CU.centroid_partial_plain(x, a, 5)
        return lambda: CU.centroid_finish(c, sums, n, 32.0)
    a, b, h0 = 0.9 + 0.05 * t(2, 50, 96), t(2, 50, 96), t(2, 96)
    if name == "rglru_scan":
        return lambda: RS.rglru_scan(a, b, h0)
    h, _ = RS.rglru_scan(a, b, h0)
    return lambda: RS.rglru_scan_bwd(a, h0, h, b)


@pytest.mark.parametrize("name", list(ops._MODULES))
def test_op_counter_items_equal_launches(cuda, name):
    """One call of each kernel's entry point under the op counter: its
    items are the kernel's launches (G's backward launches twice a call),
    and the item's work is the kernel's ``work()``."""
    from repro_torch.launch.op_cost import count

    fn = _one_call(name, cuda)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _, cost = count(fn)
    torch.cuda.synchronize()
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    items = dict(cost.kernels)
    if "flash_attention_bwd" in items:
        items["flash_attention_bwd"] *= 2
    assert items == launches and name in items


def _count_on(cfg, shape, cuda):
    """``(the card's count, the meta count)`` of the step ``shape``
    dictates for ``cfg``, the card's on seeded weights and tokens."""
    from repro_torch.launch.inputs import input_specs
    from repro_torch.launch.lowering import lower_step, step_fn
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.op_cost import count
    from repro_torch.train import adamw_init

    spec = input_specs(cfg, shape)
    params = TF.init_params(cfg, torch.Generator(device=cuda).manual_seed(3),
                            device=cuda)
    opt = adamw_init(params) if spec.step_kind == "train" else None
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (shape.global_batch, shape.seq_len)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(cuda)}
    _, card = count(step_fn(spec), params, opt, batch)
    torch.cuda.synchronize()
    meta = lower_step(cfg, shape, make_abstract_mesh((1, 1),
                                                     ("data", "model")))
    return card, meta.cost


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_card_count_equals_meta_lowering(cuda, kind):
    """The reduced qwen1.5-0.5b's prefill (and train step, two
    microbatches, its backward on autograd's device thread) counted on the
    card equals ``lower_step``'s count on ``meta`` on every field and
    item."""
    import dataclasses

    from repro_torch.configs import InputShape

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              train_microbatches=2)
    card, meta = _count_on(cfg, InputShape(kind, 64, 2, kind), cuda)
    assert card.as_dict() == meta.as_dict()
    assert card.items == meta.items
    want = {"flash_attention": cfg.n_layers} if kind == "prefill" else {
        "flash_attention": 2 * 2 * cfg.n_layers,   # remat: twice a pass
        "flash_attention_bwd": 2 * cfg.n_layers}
    assert card.kernels == want
