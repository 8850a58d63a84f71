"""The port's transformer against the JAX package.

``qwen1.5-0.5b`` (MHA with QKV bias), ``glm4-9b`` (GQA, 2 kv heads) and the
RG-LRU hybrid ``recurrentgemma-9b`` (rec, rec, attn with MQA and a 64-token
window) at their ``reduced()`` sizes (f32), with the reference's random
weights carried over by ``convert.transformer_params``.  Logits, decode
states and pooled unit features are held at rtol = atol = 1e-5 (the JAX
suite's tolerance between two evaluations of one model): an f32 matmul sums
in another order in each framework.  The hybrid's gates follow the
reference's program: ``1 - a * a`` op by op, ``1 - exp(2 log_a)`` in the
layers the reference compiles in its layer scan (prefill, the stacked
decode step, ``forward`` without remat; see
:mod:`repro_torch.models.rglru`).  Every registered config builds its
decode state (the other families run against JAX in
``tests/test_torch_zoo.py``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.core.agile import AgileTransformer as JAgile
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.configs import get_config, list_configs
from repro_torch.core.agile import AgileTransformer
from repro_torch.models import transformer as PT
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("qwen1.5-0.5b", "glm4-9b", "recurrentgemma-9b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, pcfg = jget(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, pcfg, jp, tp


def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def test_configs_resolve_every_reference_name():
    from repro.configs import list_configs as jlist

    assert list_configs() == jlist()
    for name in list_configs():
        j, p = jget(name), get_config(name)
        assert p == type(p)(**{f: getattr(j, f)
                               for f in j.__dataclass_fields__})
        assert p.reduced().n_units == j.reduced().n_units
        assert p.padded_vocab == j.padded_vocab
        assert p.resolved_mandatory_units == j.resolved_mandatory_units
        assert p.with_window(64).window == 64


def test_params_layout_matches_reference(model):
    jcfg, pcfg, jp, tp = model
    mine = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape), mine))[0])
    assert len(ref) == len(got)
    for path, leaf in ref:
        assert got[path].shape == leaf.shape, path


def test_forward_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    toks = _tokens(jcfg)
    want = np.asarray(JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})[0])
    got, aux = PT.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_forward_without_remat_matches_jax(model):
    """With remat the reduced models' one period is a leftover group that
    the reference runs op by op; without it the reference scans (compiles)
    that period, and the port forms the hybrid's gates as XLA does there."""
    jcfg, pcfg, jp, tp = model
    toks = _tokens(jcfg, seed=7)
    want = np.asarray(JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 remat=False)[0])
    got, _ = PT.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                        remat=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prefill_then_decode_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    toks = _tokens(jcfg, seed=1)
    lj, sj = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        cache_len=20)
    lp, sp = PT.prefill(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_len=20)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    rng = np.random.default_rng(2)
    for _ in range(3):
        t = rng.integers(0, jcfg.vocab, (2,)).astype(np.int32)
        lj, sj = JT.decode_step(jcfg, jp, sj, jnp.asarray(t))
        lp, sp = PT.decode_step(pcfg, tp, sp, torch.from_numpy(t))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    flat_j = jax.tree_util.tree_flatten_with_path(sj)[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), sp))[0])
    assert len(flat_p) == len(flat_j)
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_p[path], np.asarray(leaf), **TOL)


def test_unrolled_decode_matches_jax(model):
    """One buffer per layer (``stacked=False``), the anytime layout."""
    jcfg, pcfg, jp, tp = model
    sj = JT.init_decode_state(jcfg, 2, 6, cache_len=6, stacked=False)
    sp = PT.init_decode_state(pcfg, 2, 6, cache_len=6, stacked=False,
                              device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(8):     # wraps the 6-slot ring buffer
        t = rng.integers(0, jcfg.vocab, (2,)).astype(np.int32)
        lj, sj = JT.decode_step(jcfg, jp, sj, jnp.asarray(t), unroll=True)
        lp, sp = PT.decode_step(pcfg, tp, sp, torch.from_numpy(t))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    assert int(sp["pos"][0]) == 8


def test_unit_forward_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    toks = _tokens(jcfg, seed=4)
    xj, _ = JT.embed_inputs(jcfg, jp, {"tokens": jnp.asarray(toks)})
    xp, _ = PT.embed_inputs(pcfg, tp, {"tokens": torch.from_numpy(toks)})
    for u in range(jcfg.n_units):
        xj, fj = JT.unit_forward(jcfg, jp, xj, u)
        xp, fp = PT.unit_forward(pcfg, tp, xp, u)
        np.testing.assert_allclose(fp.numpy(), np.asarray(fj), **TOL)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)
    logits = PT.readout(pcfg, tp, xp)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(JT.readout(jcfg, jp, xj)), **TOL)


def test_agile_transformer_features_match_jax(model):
    jcfg, pcfg, jp, tp = model
    toks = _tokens(jcfg, B=3, S=8, seed=5)
    fj = JAgile(jcfg, jp, [None] * jcfg.n_units)._all_features(toks)
    agile = AgileTransformer(pcfg, tp, [None] * pcfg.n_units)
    fp = agile._all_features(toks)
    for a, b in zip(fp, fj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    prop = agile.unit_apply_flat(1, fp[0])
    assert prop.shape == fp[1].shape


def test_sliding_window_decode_matches_jax(model):
    """The ring-buffer decode with a window override (8 tokens, a 128-slot
    cache over a 23-token prefill): the last token's logits equal JAX's,
    and the windowed full-sequence forward within the JAX suite's own 2e-2
    (``test_sliding_window_decode_matches_windowed_forward``)."""
    jcfg, pcfg, jp, tp = model
    window, S = 8, 24
    toks = _tokens(jcfg, S=S, seed=6)
    full = PT.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)},
                      window=window)[0]
    _, sj = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :-1])},
                       window=window)
    _, sp = PT.prefill(pcfg, tp, {"tokens": torch.from_numpy(toks[:, :-1])},
                       window=window)
    lj, _ = JT.decode_step(jcfg, jp, sj, jnp.asarray(toks[:, -1]),
                           window=window)
    lp, _ = PT.decode_step(pcfg, tp, sp, torch.from_numpy(toks[:, -1]),
                           window=window)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(lp.numpy(), full[:, -1].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_convert_hybrid_params_drop_in():
    """Every leaf of the reference's recurrentgemma-9b pytree crosses over
    under its own path, shape and dtype: the rec blocks' ``gate_proj``,
    ``rec_proj``, ``out_proj``, ``conv.{w,b}``, ``rglru.{wa,ba,wx,bx,lam}``
    and their ``norm2``/``ffn``."""
    jcfg = jget("recurrentgemma-9b").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, tp))[0])
    assert len(got) == len(ref)
    for path, leaf in ref:
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf))
    rec = tp["layers"]["stack"][0]
    assert set(rec) == {"norm1", "gate_proj", "rec_proj", "conv", "rglru",
                        "out_proj", "norm2", "ffn"}
    assert set(rec["rglru"]) == {"wa", "ba", "wx", "bx", "lam"}


def test_full_hybrid_config_is_supported():
    cfg = get_config("recurrentgemma-9b")
    assert cfg.n_layers == 38 and cfg.n_units == 10
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    assert kinds.count("rec") == 26 and kinds.count("attn") == 12
    state = PT.init_decode_state(cfg.reduced(), 1, 4, device="cpu")
    assert set(state["stack"][0]) == {"h", "buf"}


@pytest.mark.parametrize("arch", list_configs())
def test_every_config_builds_its_decode_state(arch):
    """Each registered config, at its reduced size, builds its decode state
    in both layouts: KV caches for attention blocks (and the
    encoder-decoder's cross keys, values and ``enc_out``), the RG-LRU's
    ``h`` and conv buffer, the xLSTM cells as tuples; the stacked layout
    carries one leading layer axis per period."""
    cfg = get_config(arch).reduced()
    period, n_scan, rem = PT._layer_plan(cfg)
    st = PT.init_decode_state(cfg, 2, 8, device="cpu")
    un = PT.init_decode_state(cfg, 2, 8, stacked=False, device="cpu")
    assert len(st["stack"]) == len(un["stack"]) == period
    assert len(st["rem"]) == len(rem)
    want_keys = {"attn": {"k", "v"}, "rec": {"h", "buf"},
                 "mlstm": {"cell"}, "slstm": {"cell"}}
    for q in range(period):
        kind = cfg.layer_kind(q)
        keys = want_keys[kind] | ({"xk", "xv"} if cfg.is_encoder_decoder
                                  and kind == "attn" else set())
        assert set(st["stack"][q]) == keys
        assert len(un["stack"][q]) == n_scan
        flat_s = jax.tree.leaves(st["stack"][q])
        flat_u = jax.tree.leaves(un["stack"][q][0])
        assert len(flat_s) == len(flat_u)
        for a, b in zip(flat_s, flat_u):
            assert a.shape == (n_scan, *b.shape) and a.dtype == b.dtype
        if kind in ("mlstm", "slstm"):
            assert isinstance(un["stack"][q][0]["cell"], tuple)
    assert ("enc_out" in st) == cfg.is_encoder_decoder
    if cfg.is_encoder_decoder:
        assert st["enc_out"].shape == (2, cfg.n_enc_tokens, cfg.d_model)
    assert int(st["pos"].sum()) == 0
