"""The port's xLSTM cells against the JAX package.

``mlstm_seq`` / ``mlstm_step`` / ``slstm_seq`` / ``slstm_step`` and the
states they return, at the reduced xlstm-125m's widths (d_model 256, 4
heads: inner width 512, head dim 128; f32), with the reference's random
weights carried over by ``convert.tree``.  The sequence lengths cover the
mLSTM's chunking: 256 (two full chunks of 128), 200 (chunks of 8), 37
(one chunk of 37) and 131 (chunks of 1: a prime above 128).  Outputs and
states are held at rtol = atol = 1e-5, the JAX suite's tolerance between
two evaluations of one model (an f32 product sums in another order in each
framework).  Within the port, the sequence form over ``S`` followed by one
step equals the sequence form over ``S + 1`` at the last position and in
the state.  The mLSTM's two forms keep its memory under different
stabilisers ``m`` (the chunkwise form's is the chunk's bound, the step's
the recurrent max), so its states are compared as ``C * exp(m)`` and ``n *
exp(m)``, the memory both represent.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import xlstm as JX

from repro_torch import convert
from repro_torch.models import xlstm as PX
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = jget("xlstm-125m").reduced()
D, H = CFG.d_model, CFG.n_heads
SEQS = (256, 200, 37, 131)


@pytest.fixture(scope="module", params=["mlstm", "slstm"])
def cell(request):
    kind = request.param
    init = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    jp = init(jax.random.PRNGKey(3), D, H, jnp.float32)
    return kind, jp, convert.tree(jax.tree.map(np.asarray, jp), "cpu")


def _fns(kind):
    if kind == "mlstm":
        return (JX.mlstm_seq, JX.mlstm_step, PX.mlstm_seq, PX.mlstm_step)
    return (JX.slstm_seq, JX.slstm_step, PX.slstm_seq, PX.slstm_step)


def _x(B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _close_states(sp, sj):
    assert len(sp) == len(sj)
    for a, b in zip(sp, sj):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_chunking():
    assert [PX.mlstm_chunk(S) for S in SEQS + (257, 1)] == [128, 8, 37, 1, 1,
                                                         1]


def test_params_match_reference_layout(cell):
    kind, jp, tp = cell
    init = PX.init_mlstm if kind == "mlstm" else PX.init_slstm
    mine = init(torch.Generator().manual_seed(0), D, H, torch.bfloat16)
    assert set(mine) == set(jp)
    for name, leaf in jp.items():
        assert tuple(mine[name].shape) == leaf.shape, name
        # the gates (and the recurrence) stay f32 in a bf16 model
        want = (torch.bfloat16 if name in ("up", "wq", "wk", "wv", "down")
                else torch.float32)
        assert mine[name].dtype == want, name
        assert tp[name].dtype == torch.float32


@pytest.mark.parametrize("S", SEQS)
def test_seq_matches_jax(cell, S):
    kind, jp, tp = cell
    jseq, _, pseq, _ = _fns(kind)
    x = _x(2, S, S)
    yj, sj = jseq(jp, jnp.asarray(x), H)
    yp, sp = pseq(tp, torch.from_numpy(x), H)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    _close_states(sp, sj)


def test_seq_from_a_state_then_steps_match_jax(cell):
    """A sequence continued from a carried state, then decode steps from
    the state it leaves."""
    kind, jp, tp = cell
    jseq, jstep, pseq, pstep = _fns(kind)
    x = _x(2, 37, 1)
    _, sj = jseq(jp, jnp.asarray(x[:, :16]), H)
    _, sp = pseq(tp, torch.from_numpy(x[:, :16]), H)
    yj, sj = jseq(jp, jnp.asarray(x[:, 16:32]), H, state=sj)
    yp, sp = pseq(tp, torch.from_numpy(x[:, 16:32]), H, state=sp)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    for t in range(32, 37):
        yj, sj = jstep(jp, jnp.asarray(x[:, t]), H, sj)
        yp, sp = pstep(tp, torch.from_numpy(x[:, t]), H, sp)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    _close_states(sp, sj)


def test_step_from_init_state_matches_jax(cell):
    kind, jp, tp = cell
    _, jstep, _, pstep = _fns(kind)
    jinit = JX.mlstm_init_state if kind == "mlstm" else JX.slstm_init_state
    pinit = PX.mlstm_init_state if kind == "mlstm" else PX.slstm_init_state
    sj, sp = jinit(3, D, H), pinit(3, D, H, "cpu")
    _close_states(sp, sj)
    x = _x(3, 4, 2)
    for t in range(4):
        yj, sj = jstep(jp, jnp.asarray(x[:, t]), H, sj)
        yp, sp = pstep(tp, torch.from_numpy(x[:, t]), H, sp)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    _close_states(sp, sj)


@pytest.mark.parametrize("S", SEQS)
def test_seq_then_step_equals_longer_seq(cell, S):
    kind, jp, tp = cell
    _, _, pseq, pstep = _fns(kind)
    x = torch.from_numpy(_x(2, S + 1, 10 + S))
    _, s_short = pseq(tp, x[:, :S], H)
    y_step, s_step = pstep(tp, x[:, S], H, s_short)
    y_long, s_long = pseq(tp, x, H)
    np.testing.assert_allclose(y_step.numpy(), y_long[:, -1].numpy(), **TOL)
    for a, b in zip(_memory(kind, s_step), _memory(kind, s_long)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _memory(kind, state):
    """A cell state as the memory it represents: the mLSTM's ``(C, n)``
    unscaled by its stabiliser, the sLSTM's ``(c, n, m, h)`` as it is."""
    if kind == "slstm":
        return state
    C, n, m = state
    scale = torch.exp(m.to(torch.float64))
    return (C * scale[..., None, None], n * scale[..., None])
