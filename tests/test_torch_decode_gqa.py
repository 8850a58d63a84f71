"""Kernel H (``decode_gqa``) of the port against the JAX package.

* ``round_p=False`` (the Pallas kernel's function) against
  ``repro.kernels.ops.decode_gqa`` in interpret mode at the JAX sweep's
  four shapes x window {0, 16} and its odd shape, at the JAX suite's
  rtol 1e-4 / atol 1e-5; and a query that sees no valid slot, which the
  reference answers with the mean of ``v`` over its padded slot count.
* ``round_p=True`` (the model's ``decode_attention``: the normalised
  softmax rounded to the cache's dtype before the PV product) against the
  JAX ``decode_attention`` in f32 and in bf16, at the same tolerance.
* The slice entries' plain versions (a cache cut by length over mesh
  blocks): the stats' maxima and sums, and the PV sums fed the stats' kept
  scores, equal the same functions forming every score again from ``q``
  and ``k``, bit for bit, at ``tests/test_torch_gpu.py``'s slice cases.

Inputs are made with numpy from a seed and go through both packages.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops
from repro.models.attention import decode_attention as jax_decode_attention

from repro_torch.kernels import decode_gqa as DG
from repro_torch.models.attention import decode_attention
from repro_torch.models.common import block_sum
from _torch_threads import one_torch_thread  # noqa: F401
# (B, H, KV, hd, C, window, n): each cache cut by length into n slices
from test_torch_gpu import SLICE_CASES

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(B, H, KV, hd, C, seed, pos=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    if pos is None:
        pos = rng.integers(1, C + 1, B)
    pos = np.asarray(pos, np.int32)
    slot = np.stack([np.where(np.arange(C) < p, np.arange(C), -1)
                     for p in pos]).astype(np.int32)
    return q, kc, vc, slot, pos


@pytest.mark.parametrize("B,H,KV,hd,C,blocks", [
    (1, 4, 4, 16, 32, {}), (4, 8, 2, 32, 128, {}), (2, 16, 1, 64, 64, {}),
    (3, 8, 8, 32, 96, {}), (5, 4, 2, 16, 37, dict(block_b=4, block_c=16)),
])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_gqa_plain_matches_jax(B, H, KV, hd, C, blocks, window):
    args = _inputs(B, H, KV, hd, C, seed=B * H + C)
    want = ops.decode_gqa(*args, window=window, **blocks)
    before = DG.launches
    got = DG.decode_gqa(*map(torch.from_numpy, args), window=window)
    assert got.dtype == torch.float32
    assert DG.launches == before               # the CPU never launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_gqa_plain_no_valid_slot_matches_jax():
    """Every slot empty, C = 600 (two 512-slot tiles in the reference):
    the reference's online softmax takes p = 1 on every slot, padded ones
    included, so it returns sum(v) / 1,024."""
    q, kc, vc, _, _ = _inputs(2, 4, 2, 16, 600, seed=3)
    slot = np.full((2, 600), -1, np.int32)
    pos = np.zeros(2, np.int32)
    want = np.asarray(ops.decode_gqa(q, kc, vc, slot, pos))
    got = DG.decode_gqa(*map(torch.from_numpy, (q, kc, vc, slot, pos)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    mean = vc.sum(axis=1) / 1024.0                        # (B, KV, hd)
    np.testing.assert_allclose(got.numpy()[:, 0], mean[:, 0], **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,C,pos", [
    (2, 8, 4, 32, 64, (40, 64)), (2, 16, 1, 64, 64, (17, 64)),
])
def test_decode_gqa_round_p_matches_model_attention(dtype, B, H, KV, hd, C,
                                                    pos):
    """The model-attention test's shape and recurrentgemma's MQA group
    (16 heads on one kv head); bf16 operands as the model stores them,
    outputs compared in the model's dtype."""
    q, kc, vc, slot, posa = _inputs(B, H, KV, hd, C, seed=5, pos=pos)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, kc, vc))
    want = jax_decode_attention(jq, jk, jv, jnp.asarray(slot),
                                jnp.asarray(posa))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in (jq, jk, jv))
    got = DG.decode_gqa(tq, tk, tv, torch.from_numpy(slot),
                        torch.from_numpy(posa), round_p=True)
    got = got.to(getattr(torch, dtype)).to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               **TOL)
    # the model's CPU path computes the same function
    mine = decode_attention(tq, tk, tv, torch.from_numpy(slot),
                            torch.from_numpy(posa))
    np.testing.assert_allclose(mine.to(torch.float32).numpy(), got, **TOL)


def test_decode_gqa_round_p_no_valid_slot_is_uniform():
    """``decode_attention``'s softmax of all ``-1e30`` is uniform: p = 1/C
    on every slot."""
    q, kc, vc, _, _ = _inputs(1, 4, 1, 16, 37, seed=4)
    slot = np.full((1, 37), -1, np.int32)
    pos = np.zeros(1, np.int32)
    want = jax_decode_attention(*map(jnp.asarray, (q, kc, vc, slot, pos)))
    got = DG.decode_gqa(*map(torch.from_numpy, (q, kc, vc, slot, pos)),
                        round_p=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_gqa_wrapper_rejects_bad_inputs():
    q, kc, vc, slot, pos = map(torch.from_numpy,
                               _inputs(2, 4, 2, 16, 8, seed=0))
    with pytest.raises(ValueError):
        DG.decode_gqa(q, kc, vc[:, :7], slot, pos)
    with pytest.raises(ValueError):
        DG.decode_gqa(q[:, :3], kc, vc, slot, pos)       # H % KV
    with pytest.raises(TypeError):
        DG.decode_gqa(q.double(), kc.double(), vc.double(), slot, pos)
    with pytest.raises(TypeError):
        DG.decode_gqa(q, kc, vc, slot.float(), pos)


@pytest.mark.parametrize("B,KV,C", [(1, 1, 2176), (16, 1, 64), (1, 16, 4160),
                                    (1, 2, 4096), (2, 1, 37), (2, 1, 4097),
                                    (20, 8, 1000), (1, 1, 65), (131, 1, 999)])
def test_split_plan_covers_the_cache_in_whole_tiles(B, KV, C):
    """Kernel H's split: chunks of whole 64-slot tiles (the last ragged)
    that cover the cache once, at most four blocks per SM of the card's
    132 in all, and one chunk where ``B * KV`` fills the SMs or the cache
    is a single tile (the engine batch of 16 rows x 64 slots)."""
    ns, chunk = DG.split_plan(B, KV, C, 132)
    assert (ns - 1) * chunk < C <= ns * chunk
    if ns > 1:
        assert chunk % DG.TILE == 0
        assert B * KV * ns <= DG.BLOCKS_PER_SM * 132
    assert (ns == 1) == (B * KV >= 132 or C <= DG.TILE)


def test_split_denominator_rounds_as_the_plain_one():
    """The premise of the split: the f64 sum of p over a (row, head),
    taken chunk by chunk and the chunk sums added in split order, rounds to
    the same f32 as the plain version's sum, so the weights agree bit for
    bit.  At the hybrid's decode shape (16 heads, 2,176 slots, 34 chunks)
    on 64 draws of scores."""
    rng = np.random.default_rng(12)
    ns, chunk = DG.split_plan(1, 1, 2176, 132)
    s = torch.from_numpy(rng.normal(0, 3, (64, 16, 2176)).astype(np.float32))
    p = torch.exp((s - s.amax(-1, keepdim=True)).double()).float()
    plain = p.double().sum(-1).float()
    parts = [p[..., i * chunk:(i + 1) * chunk].double().sum(-1)
             for i in range(ns)]
    split = torch.zeros_like(parts[0])
    for part in parts:
        split = split + part
    assert torch.equal(split.float(), plain)


def _stats_from_q(q, k, slot_pos, my_pos, window):
    """The slice stats as the plain entry formed them before it kept its
    scores: ``(pmax, psum)``."""
    B, H, _ = q.shape
    s = DG._scores_plain(q, k, slot_pos, my_pos, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m).to(torch.float64)).to(torch.float32)
    return m.reshape(B, H), p.to(torch.float64).sum(dim=-1).reshape(B, H)


def _pv_from_q(q, k, v, slot_pos, my_pos, m, l, window):
    """The slice PV sums as the plain entry formed them before: every score
    formed again from ``q`` and ``k``."""
    B, H, hd = q.shape
    KV = k.shape[2]
    s = DG._scores_plain(q, k, slot_pos, my_pos, window)
    p = torch.exp((s - m.reshape(B, KV, H // KV, 1)).to(torch.float64))
    p = (p.to(torch.float32) / l.reshape(B, KV, H // KV, 1)).to(
        v.dtype).to(torch.float32)
    o = torch.einsum("bkgc,bckh->bkgh", p, v.to(torch.float32))
    return o.reshape(B, H, hd)


@pytest.mark.parametrize("case", SLICE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slice_entries_with_kept_scores_equal_the_scores_formed_again(
        case, dtype):
    """The plain stats entry's maxima and sums, and the plain PV entry fed
    its kept scores, equal the same functions forming every score again
    from ``q`` and ``k`` bit for bit, slice by slice; the slices' PV sums
    added in block order are H on the whole cache within 1e-5 in f32."""
    B, H, KV, hd, C, window, n = case
    rng = np.random.default_rng(C + n)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        dtype) for sh in ((B, H, hd), (B, C, KV, hd), (B, C, KV, hd)))
    pos = rng.integers(1, C + 1, B)
    slot_pos = torch.from_numpy(np.where(np.arange(C)[None] < pos[:, None],
                                         np.arange(C)[None], -1))
    pos = torch.from_numpy((pos - 1).astype(np.int32))
    cut = -(-C // n)
    bounds = [(i * cut, min(C, (i + 1) * cut)) for i in range(n)]
    ks, vs, sps = ([t[:, a:b].contiguous() for a, b in bounds]
                   for t in (k, v, slot_pos))
    stats = [DG.decode_gqa_stats(q, a, s, pos, window=window)
             for a, s in zip(ks, sps)]
    for (m1, l1, s1), a, s in zip(stats, ks, sps):
        m2, l2 = _stats_from_q(q, a, s, pos, window)
        assert s1.shape == (B, H, a.shape[1])
        assert torch.equal(m1, m2) and torch.equal(l1, l2)
    m, l = DG.decode_gqa_merge(torch.stack([x[0] for x in stats]),
                               torch.stack([x[1] for x in stats]))
    pvs = [DG.decode_gqa_pv(x[2], b, m, l) for x, b in zip(stats, vs)]
    for o, a, b, s in zip(pvs, ks, vs, sps):
        assert torch.equal(o, _pv_from_q(q, a, b, s, pos, m, l, window))
    if dtype == torch.float32:
        whole = DG.decode_gqa_plain(q, k, v, slot_pos, pos, window=window,
                                    round_p=True)
        torch.testing.assert_close(block_sum(pvs), whole, rtol=1e-5,
                                   atol=1e-5)
