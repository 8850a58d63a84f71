"""Anytime serving in the port: exit heads over the transformer (dense and
the RG-LRU hybrid) and the continuous-batching engine, against the JAX
package.

* Within the port, the full-depth rows of ``anytime_forward`` /
  ``unit_decode_step`` equal ``forward`` / ``decode_step`` bit for bit
  (the reference's contract, ``tests/test_anytime.py``).
* ``margins``, ``select_depth``, ``take_at_depth`` and
  ``calibrate_thresholds`` equal the JAX functions exactly on the same
  inputs.
* The engine's result arrays equal the JAX engine's bit for bit on the
  tiny model of ``tests/test_anytime.py`` (weights carried over), for
  ``anytime``, ``edf`` and ``edf-m`` and for 1 and 4 segments, and on the
  reduced recurrentgemma-9b (rec, rec, attn: 3 units), xlstm-125m and
  dbrx-132b (those cases in ``tests/test_torch_anytime_engine.py``, which
  imports this file's helpers); with a small capacitor the clock and the
  charge also match after every step.
  The model's logits differ from JAX's at f32 round-off, so a margin at a
  threshold or a near-tie of two logits could flip a decision: the
  thresholds used here (0.1, 0.3, 1e9) and the seeded inputs keep away
  from ties, which the exact equality of the results confirms.
* ``score_fn`` and the ``adapt.anytime`` tuning smoke give JAX's scores.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import adapt as JAD
from repro.configs import get_config as jget
from repro.models import anytime as JA
from repro.models import transformer as JT
from repro.serve import AnytimeConfig as JConfig
from repro.serve import AnytimeRequest as JRequest
from repro.serve import AnytimeServeEngine as JEngine

from repro_torch import adapt as PAD
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import anytime as A
from repro_torch.models import transformer as T
from repro_torch.serve import AnytimeConfig, AnytimeRequest
from repro_torch.serve import AnytimeServeEngine
from repro_torch.telemetry import TelemetryConfig
from _torch_threads import one_torch_thread  # noqa: F401

RESULT_FIELDS = ("status", "finish", "tardiness", "agree", "tokens",
                 "depth_sum")
TINY = dict(n_layers=4, vocab=64, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=16, d_ff=128, exit_every=1)


def _port_model(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    pcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, pcfg, jp, tp


@pytest.fixture(scope="module")
def tiny():
    return _port_model("qwen1.5-0.5b", **TINY)


# --------------------------------------------------------------------- #
# Full depth equals the stock model, bit for bit, within the port.
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "glm4-9b",
                                  "recurrentgemma-9b"])
def test_full_depth_rows_bit_exact(arch):
    _, cfg, _, params = _port_model(arch, n_layers=4, exit_every=2)
    heads = A.init_heads(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    ref = T.forward(cfg, params, {"tokens": toks})[0]
    got = A.anytime_forward(cfg, params, heads, {"tokens": toks})
    assert got.shape == (cfg.n_units, 2, 16, cfg.vocab)
    assert torch.equal(got[-1], ref)

    s_ref = T.init_decode_state(cfg, 2, 8, cache_len=8, stacked=False,
                                device="cpu")
    s_any = T.init_decode_state(cfg, 2, 8, cache_len=8, stacked=False,
                                device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(4):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2,)).astype(
            np.int32))
        l_ref, s_ref = T.decode_step(cfg, params, s_ref, tok, unroll=True)
        ul, s_any = A.unit_decode_step(cfg, params, heads, s_any, tok)
        assert ul.shape == (cfg.n_units, 2, cfg.vocab)
        assert torch.equal(ul[-1], l_ref)
    for a, b in zip(jax.tree.leaves(s_ref), jax.tree.leaves(s_any)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# The utility test and calibration, exactly as JAX.
# --------------------------------------------------------------------- #


def test_margins_select_take_match_jax():
    rng = np.random.default_rng(0)
    U, N, V = 4, 64, 33
    logits = rng.normal(size=(U, N, V)).astype(np.float32)
    logits[:, :4, :2] = 3.0                      # ties at the top two
    mj = np.asarray(JA.margins(jnp.asarray(logits)))
    mp = A.margins(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(mp, mj)
    for mand in (1, 2, 4):
        for thr in (0.0, 0.5, 1.0):
            t = np.full((U,), thr, np.float32)
            use = np.array([1, 0, 1, 1], np.float32)
            dj, ej = JA.select_depth(jnp.asarray(mj), jnp.asarray(t),
                                     jnp.asarray(use), mand)
            dp, ep = A.select_depth(torch.from_numpy(mp),
                                    torch.from_numpy(t),
                                    torch.from_numpy(use), mand)
            np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
            np.testing.assert_array_equal(ep.numpy(), np.asarray(ej))
    depth = rng.integers(1, U + 1, N).astype(np.int32)
    np.testing.assert_array_equal(
        A.take_at_depth(torch.from_numpy(logits),
                        torch.from_numpy(depth)).numpy(),
        np.asarray(JA.take_at_depth(jnp.asarray(logits),
                                    jnp.asarray(depth))))


@pytest.mark.parametrize("target", [0.5, 0.9, 0.98])
def test_calibrate_thresholds_matches_jax(target):
    rng = np.random.default_rng(3)
    U, N, V = 4, 200, 17
    base = rng.normal(size=(N, V)).astype(np.float32)
    logits = np.stack([base + rng.normal(size=(N, V)).astype(np.float32)
                       * s for s in (1.5, 0.8, 0.3, 0.0)])
    tj, uj = JA.calibrate_thresholds(jnp.asarray(logits),
                                     target_agreement=target)
    for src in (torch.from_numpy(logits), logits):
        tp, up = A.calibrate_thresholds(src, target_agreement=target)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(up.numpy(), np.asarray(uj))


# --------------------------------------------------------------------- #
# The engine, bit for bit against the JAX engine.
# --------------------------------------------------------------------- #


def _engines(tiny, supply=None, **sc):
    jcfg, pcfg, jp, tp = tiny
    sc = dict(dict(batch_slots=2, max_steps=160, prompt_len=2,
                   max_new_tokens=4), **sc)
    return (JEngine(jcfg, jp, serve_cfg=JConfig(**sc), supply=supply),
            AnytimeServeEngine(pcfg, tp, serve_cfg=AnytimeConfig(**sc),
                               supply=supply))


def _requests(n=6, *, gap=0.3, slack=2.5, ragged=False):
    out = []
    for i in range(n):
        prompt = (1 + i % 4, 2) if not ragged else (1 + i % 5,) * (
            1 + i % 2)
        out.append(dict(prompt=prompt, n_tokens=3, release=gap * i,
                        deadline=gap * i + slack))
    return ([JRequest(**r) for r in out], [AnytimeRequest(**r) for r in out])


def _assert_same(jres, pres):
    for name in RESULT_FIELDS:
        a, b = getattr(pres, name), getattr(jres, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert pres.horizon == jres.horizon
    assert pres.as_dict() == jres.as_dict()


@pytest.mark.parametrize("policy", ["anytime", "edf", "edf-m"])
def test_engine_clock_and_charge_match_jax_every_step(tiny, policy):
    """A 2 J capacitor at half charge on a 3.3 W supply: the charge moves
    every step, so the capacitor update's fused multiply-add shows (with
    two roundings the charge differs within the run)."""
    je, pe = _engines(tiny, supply=np.full(64, 3.3), policy=policy,
                      max_steps=120, capacity=2.0, start_frac=0.5)
    jk = je.default_knobs(exit_thr=jnp.full((4,), 0.3, jnp.float32),
                          eta=0.8, e_opt_fraction=0.3)
    pk = pe.default_knobs(exit_thr=np.full((4,), 0.3, np.float32), eta=0.8,
                          e_opt_fraction=0.3)
    jreqs, preqs = _requests(8, gap=0.4, slack=3.0, ragged=True)
    jh, ph = [], []
    jres = je.run(jreqs, knobs=jk, n_segments=120,
                  hook=lambda s, c, k: jh.append((float(c.now),
                                                  float(c.energy))))
    pres = pe.run(preqs, knobs=pk, n_segments=120,
                  hook=lambda s, c, k: ph.append((float(c.now),
                                                  float(c.energy))))
    assert ph == jh
    _assert_same(jres, pres)


def test_engine_rejects_what_it_does_not_run(tiny):
    """``telemetry=`` runs and leaves the result arrays as the plain
    run's; so does ``mesh=`` on a one-device host mesh (the decode state
    placed by ``state_specs``) and on a mesh of two devices, whose blocks
    each serve one slot (``tests/test_torch_anytime_mesh.py`` holds larger
    meshes to the reference's multi-device runs)."""
    _, pe = _engines(tiny)
    _, preqs = _requests()
    out = pe.run(preqs, telemetry=TelemetryConfig(level="full"))
    plain = pe.run(preqs)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(out, name),
                                      getattr(plain, name), err_msg=name)
    assert int(out.telemetry.exit_hist.sum()) == int(out.tokens.sum())
    on_mesh = pe.run(preqs, mesh=make_host_mesh("cpu"))
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(on_mesh, name),
                                      getattr(plain, name), err_msg=name)
    on_two = pe.run(preqs, mesh=make_mesh((2, 1), ("data", "model"), "cpu"))
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(on_two, name),
                                      getattr(plain, name), err_msg=name)


def test_score_fn_and_tune_match_jax(tiny):
    """``score_fn`` over a candidate block and ``tune(driver="random")``
    give the JAX scores, so the search picks the same knobs."""
    je, pe = _engines(tiny, max_steps=60)
    jreqs, preqs = _requests(4)
    cand = {"exit_threshold": np.array([0.0, 0.4, 3.0], np.float32),
            "e_opt_fraction": np.array([0.9, 0.25, 0.05], np.float32)}
    want = JAD.make_anytime_objective(je, jreqs)(cand)
    got = PAD.make_anytime_objective(pe, preqs)(cand)
    np.testing.assert_array_equal(got, np.asarray(want))

    jt = JAD.tune(JAD.make_anytime_objective(je, jreqs),
                  JAD.anytime_space(je), budget=4, driver="random", seed=0)
    pt = PAD.tune(PAD.make_anytime_objective(pe, preqs),
                  PAD.anytime_space(pe), budget=4, driver="random", seed=0)
    assert pt.best_params == jt.best_params
    assert pt.best_score == jt.best_score
    kj = JAD.knobs_from_params(je, jt.best_params)
    kp = PAD.knobs_from_params(pe, pt.best_params)
    for a, b in zip(kp, kj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_same(je.run(jreqs, knobs=kj), pe.run(preqs, knobs=kp))
