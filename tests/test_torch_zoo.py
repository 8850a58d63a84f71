"""The rest of the model zoo through the port's transformer, against the JAX
package.

dbrx-132b and qwen3-moe-235b-a22b (the MoE FFN), xlstm-125m (mLSTM, sLSTM),
seamless-m4t-medium (a bidirectional encoder over stub frames and
cross-attention in every decoder block) and internvl2-2b (stub patches
prepended to the text) at their ``reduced()`` sizes (f32), with the
reference's random weights carried over by ``convert.transformer_params``.
``forward`` (logits and the MoE aux loss), ``prefill`` + ``decode_step``
(logits and every leaf of the decode state), the unrolled decode,
``unit_forward``, ``anytime_forward`` and the parameter layout are held at
rtol = atol = 1e-5, the JAX suite's tolerance between two evaluations of
one model (an f32 product sums in another order in each framework).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import anytime as JA
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import anytime as A
from repro_torch.models import transformer as PT
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("dbrx-132b", "qwen3-moe-235b-a22b", "xlstm-125m",
         "seamless-m4t-medium", "internvl2-2b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, pcfg = jget(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, pcfg, jp, tp


def _batch(cfg, B=2, S=16, seed=0):
    """Tokens, and the stub frames (encoder-decoder) or patches (VLM)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    n_front = cfg.n_enc_tokens or cfg.n_frontend_tokens
    if n_front:
        out["frontend"] = rng.normal(size=(B, n_front, cfg.d_model)).astype(
            np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.asarray(t), tree))[0])


def _assert_same_tree(port, ref):
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    got = _flat(jax.tree.map(lambda t: t.numpy(), port))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), **TOL,
                                   err_msg=str(path))


def test_params_layout_matches_reference(model):
    """The port's own ``init_params`` builds the reference's tree: every
    leaf under its path with its shape and dtype (the MoE router and the
    xLSTM gates f32), and the converted tree carries every leaf."""
    jcfg, pcfg, jp, tp = model
    mine = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, mine))[0])
    conv = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, tp))[0])
    assert len(ref) == len(got) == len(conv)
    for path, leaf in ref:
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(conv[path].numpy(), np.asarray(leaf))
    bf = PT.init_params(dataclasses.replace(pcfg, dtype="bfloat16"),
                        torch.Generator().manual_seed(0), device="cpu")
    gates = {"wi", "wf", "bi", "bf", "wz", "wo", "r"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t, bf))[0]:
        keys = [getattr(k, "key", None) for k in path]
        f32 = keys[-1] == "router" or ("cell" in keys and keys[-1] in gates)
        assert (leaf.dtype == torch.float32) == f32, path


def test_forward_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    b = _batch(jcfg)
    lj, aj = JT.forward(jcfg, jp, _jb(b))
    lp, ap = PT.forward(pcfg, tp, _pb(b))
    n_front = jcfg.n_frontend_tokens
    assert lp.shape == (2, 16 + n_front, jcfg.padded_vocab)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(ap), float(aj), **TOL)
    assert (float(ap) > 0) == bool(jcfg.n_experts)


def test_prefill_then_decode_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    b = _batch(jcfg, seed=1)
    lj, sj = JT.prefill(jcfg, jp, _jb(b), cache_len=40)
    lp, sp = PT.prefill(pcfg, tp, _pb(b), cache_len=40)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    _assert_same_tree(sp, sj)
    rng = np.random.default_rng(2)
    for _ in range(3):
        t = rng.integers(0, jcfg.vocab, (2,)).astype(np.int32)
        lj, sj = JT.decode_step(jcfg, jp, sj, jnp.asarray(t))
        lp, sp = PT.decode_step(pcfg, tp, sp, torch.from_numpy(t))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    _assert_same_tree(sp, sj)
    assert int(sp["pos"][0]) == 16 + jcfg.n_frontend_tokens + 3


def test_decode_from_a_converted_jax_state(model):
    """The reference's own prefill state (xLSTM cells as tuples, the
    encoder-decoder's ``enc_out`` and cross keys and values), converted by
    ``convert.tree``, decodes in the port as it does in JAX."""
    jcfg, pcfg, jp, tp = model
    _, sj = JT.prefill(jcfg, jp, _jb(_batch(jcfg, seed=6)), cache_len=24)
    sp = convert.tree(jax.tree.map(np.asarray, sj), "cpu")
    _assert_same_tree(sp, sj)
    t = np.random.default_rng(7).integers(0, jcfg.vocab, (2,)).astype(
        np.int32)
    lj, sj = JT.decode_step(jcfg, jp, sj, jnp.asarray(t))
    lp, sp = PT.decode_step(pcfg, tp, sp, torch.from_numpy(t))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    _assert_same_tree(sp, sj)


def test_unrolled_decode_matches_jax(model):
    """One buffer per layer (``stacked=False``), the anytime layout, from
    the zero state the engine admits a request with."""
    jcfg, pcfg, jp, tp = model
    sj = JT.init_decode_state(jcfg, 2, 6, cache_len=6, stacked=False)
    sp = PT.init_decode_state(pcfg, 2, 6, cache_len=6, stacked=False,
                              device="cpu")
    _assert_same_tree(sp, sj)
    rng = np.random.default_rng(3)
    for _ in range(8):     # wraps the 6-slot ring buffer
        t = rng.integers(0, jcfg.vocab, (2,)).astype(np.int32)
        lj, sj = JT.decode_step(jcfg, jp, sj, jnp.asarray(t), unroll=True)
        lp, sp = PT.decode_step(pcfg, tp, sp, torch.from_numpy(t))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    _assert_same_tree(sp, sj)


def test_unit_forward_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    b = _batch(jcfg, seed=4)
    xj, ej = JT.embed_inputs(jcfg, jp, _jb(b))
    xp, ep = PT.embed_inputs(pcfg, tp, _pb(b))
    assert (ep is None) == (ej is None)
    if ej is not None:
        np.testing.assert_allclose(ep.numpy(), np.asarray(ej), **TOL)
    for u in range(jcfg.n_units):
        xj, fj = JT.unit_forward(jcfg, jp, xj, u, enc_out=ej)
        xp, fp = PT.unit_forward(pcfg, tp, xp, u, enc_out=ep)
        np.testing.assert_allclose(fp.numpy(), np.asarray(fj), **TOL)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)


def test_anytime_forward_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    b = _batch(jcfg, seed=5)
    want = JA.anytime_forward(jcfg, jp, JA.init_heads(jcfg), _jb(b))
    got = A.anytime_forward(pcfg, tp, A.init_heads(pcfg, device="cpu"),
                            _pb(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the full-depth row is the port's own forward, bit for bit
    assert torch.equal(got[-1], PT.forward(pcfg, tp, _pb(b))[0])
