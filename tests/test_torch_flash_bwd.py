"""Kernel G's backward, plain version, against the JAX package.

``flash_attention_bwd_plain`` (the formulas ``csrc/flash_attn_bwd.cu``
computes, tile by tile) against ``jax.vjp`` of
``repro/kernels/ref.py:flash_attention_ref`` in f32 at rtol = atol = 1e-5
(both sum in f32, in other orders), for query-head groups 1, 2 and 6,
causal, a window, and non-causal with ``S != Skv`` and a ``q_offset``; the
rows' log-sum-exp the forward returns for it against JAX's ``logsumexp`` of
the masked scores; the forward's ``out`` unchanged by ``return_lse``; rows
that see no key (the dead-row witness, a negative offset, and ``Skv`` no
multiple of the reference's tile against autograd of the port's forward);
the bf16 kernels' tile plans (``bwd_dq_plan``, ``bwd_dkdv_plan``) covering
every visible (row, key) pair exactly once, and ``dead_positions`` naming
exactly the rows that see no key, at the GPU tests' shapes; and the
wrapper's dispatch on the CPU.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.kernels import ref

from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ops

from test_torch_gpu import FLASH_BWD_CASES

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [  # B, S, Skv, H, KV, hd, causal, window, q_offset
    (2, 40, 40, 4, 4, 16, True, 0, 0),
    (1, 70, 70, 4, 2, 32, True, 0, 0),
    (1, 67, 67, 12, 2, 8, True, 16, 0),
    (2, 24, 56, 6, 1, 16, False, 0, 7),
    (1, 16, 80, 4, 4, 16, True, 0, 64),
    # rows that see no key: the witness of the dead-row fault (row 5 of a
    # window-3 offset past the keys) and causal rows before key 0
    (1, 6, 16, 2, 1, 8, False, 3, 14),
    (1, 20, 24, 4, 2, 8, True, 0, -6),
]


def _inputs(B, S, Skv, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    dout = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_plain_matches_jax_vjp(case):
    B, S, Skv, H, KV, hd, causal, window, qo = case
    q, k, v, dout = _inputs(B, S, Skv, H, KV, hd, sum(case[:6]))
    fn = lambda q, k, v: ref.flash_attention_ref(  # noqa: E731
        q, k, v, causal=causal, window=window, q_offset=qo)
    want = jax.jit(lambda q, k, v, do: jax.vjp(fn, q, k, v)[1](do))(
        *(jnp.asarray(x) for x in (q, k, v, dout)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, q_offset=qo,
                                        return_lse=True)
    got = FA.flash_attention_bwd_plain(tq, tk, tv, out, lse,
                                       torch.from_numpy(dout), causal=causal,
                                       window=window, q_offset=qo)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_flash_forward_lse_matches_jax(case):
    B, S, Skv, H, KV, hd, causal, window, qo = case
    q, k, v, _ = _inputs(B, S, Skv, H, KV, hd, 1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, q_offset=qo,
                                        return_lse=True)
    assert torch.equal(out, FA.flash_attention_plain(
        tq, tk, tv, causal=causal, window=window, q_offset=qo))
    G = H // KV

    @jax.jit
    def want(q, k):
        s = jnp.einsum("bqkgh,bckh->bqkgc", q.reshape(B, S, KV, G, hd),
                       k) * hd ** -0.5
        qpos = jnp.arange(S)[:, None] + qo
        kpos = jnp.arange(Skv)[None, :]
        mask = jnp.ones((S, Skv), bool)
        if causal:
            mask &= qpos >= kpos
        if window:
            mask &= qpos - kpos <= window
        s = jnp.where(mask[None, :, None, None, :], s, -jnp.inf)
        return jax.scipy.special.logsumexp(s, axis=-1).reshape(B, S, H)

    want = np.asarray(want(jnp.asarray(q), jnp.asarray(k)))
    # a row that sees no key: -inf in JAX, the forward's -1e30 here
    dead = np.isneginf(want)
    assert (lse.numpy()[dead] == FA.NEG).all()
    np.testing.assert_allclose(lse.numpy()[~dead], want[~dead], **TOL)


def test_flash_bwd_plain_matches_autograd_of_the_forward():
    q, k, v, dout = _inputs(1, 33, 33, 6, 2, 16, 5)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FA.flash_attention_plain(tq, tk, tv, causal=True, window=8)
    out.backward(torch.from_numpy(dout))
    with torch.no_grad():
        o2, lse = FA.flash_attention_plain(tq, tk, tv, causal=True, window=8,
                                           return_lse=True)
        got = FA.flash_attention_bwd_plain(tq, tk, tv, o2, lse,
                                           torch.from_numpy(dout),
                                           causal=True, window=8)
    for g, t in zip(got, (tq, tk, tv)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), **TOL)


def test_flash_bwd_dead_rows_move_only_dv():
    """The dead-row witness (numpy seed 0; row 5 sees no key): ``dv``
    within 1e-6 of ``jax.vjp`` of the reference, and ``dq`` and ``dk`` bit
    for bit those of the same call with the dead row's ``dout`` zeroed (a
    row that sees no key moves neither)."""
    B, S, Skv, H, KV, hd = 1, 6, 16, 2, 1, 8
    kw = dict(causal=False, window=3, q_offset=14)
    q, k, v, dout = _inputs(B, S, Skv, H, KV, hd, 0)
    fn = lambda q, k, v: ref.flash_attention_ref(q, k, v, **kw)  # noqa: E731
    want = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))[1](
        jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = FA.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    dead = lse == FA.NEG
    assert dead[0, 5].all() and int(dead.sum()) == H
    got = FA.flash_attention_bwd_plain(tq, tk, tv, out, lse,
                                       torch.from_numpy(dout), **kw)
    assert float((got[2] - torch.from_numpy(np.array(want[2]))).abs()
                 .max()) <= 1e-6
    quiet = torch.from_numpy(dout).masked_fill(dead[..., None], 0.0)
    base = FA.flash_attention_bwd_plain(tq, tk, tv, out, lse, quiet, **kw)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    assert not torch.equal(got[2], base[2])


def test_flash_bwd_plain_dead_rows_match_autograd_of_the_forward():
    """Dead rows where ``Skv`` (200) is no multiple of the reference's
    128-key tile: the forward divides their mean by 256, so the backward
    is held to autograd of the port's own forward, its CPU training
    path."""
    kw = dict(causal=False, window=5, q_offset=200)
    q, k, v, dout = _inputs(1, 8, 200, 4, 2, 8, 6)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FA.flash_attention_plain(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(dout))
    with torch.no_grad():
        o2, lse = FA.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
        assert int((lse == FA.NEG).sum()) == 3 * 4   # positions 5, 6, 7
        got = FA.flash_attention_bwd_plain(tq, tk, tv, o2, lse,
                                           torch.from_numpy(dout), **kw)
    for g, t in zip(got, (tq, tk, tv)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), **TOL)


def test_flash_bwd_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _inputs(1, 20, 20, 4, 2, 16, 9))
    out, lse = FA.flash_attention_plain(q, k, v, return_lse=True)
    before = ops.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout.float())
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout.float())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert ops.launch_counts() == before


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_bwd_tile_plans_cover_each_visible_pair_once(case):
    """The dq kernel's key tiles and the dk/dv kernel's row tiles (the
    bf16 instance's arithmetic, mirrored in ``flash_attn.py``) each take
    every visible (position, key) pair exactly once; a tile holds every
    head of its positions, so every (row, key) pair with them."""
    B, S, Skv, H, KV, hd, causal, window, qo = case
    G = H // KV
    qpos = np.arange(S)[:, None] + qo
    kpos = np.arange(Skv)[None, :]
    seen = np.ones((S, Skv), bool)
    if causal:
        seen &= qpos >= kpos
    if window:
        seen &= qpos - kpos <= window
    dq = np.zeros((S, Skv), np.int8)
    for p0, p1, keys in FA.bwd_dq_plan(S, Skv, G, hd, causal, window, qo):
        assert p1 - p0 <= FA.bwd_dq_rows(hd) // G
        for k0 in keys:
            dq[p0:p1, k0:k0 + FA.BLOCK_K] += 1
    ppb = FA.BLOCK_K // G
    dkdv = np.zeros((S, Skv), np.int8)
    for k0, starts in FA.bwd_dkdv_plan(S, Skv, G, causal, window, qo):
        for p in starts:
            dkdv[p:p + ppb, k0:k0 + FA.BLOCK_K] += 1
    for count in (dq, dkdv):
        assert (count[seen] == 1).all() and count.max() <= 1
    # the rows that see no key, which every dk/dv block adds after its
    # tiles: exactly the kernels' dead prefix and suffix
    pre, suf = FA.dead_positions(S, Skv, causal, window, qo)
    assert (np.flatnonzero(~seen.any(axis=1)) == np.r_[0:pre, suf:S]).all()
