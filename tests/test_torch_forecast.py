"""The port's harvest forecaster (``repro_torch.adapt.forecast``) against
the JAX package ``repro.adapt.forecast``.

``window_features`` is host-side numpy in both packages.  The forecaster
keeps numpy tables and runs its kernels on the port's tensors: the seeding
through ``pairwise_l1`` (kernel F), the classify through ``l1_topk2`` (D)
and the centroid update through ``centroid_update`` (E), here their plain
versions on the CPU.  The tables it learns, its predictions, and the
forecast arm of ``examples/online_adapt.py`` over one cycle on a fleet of
four devices (so the seeding runs F) must equal the reference's bit for
bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import adapt as JA
from repro import fleet as JF

from repro_torch import adapt as PA
from repro_torch import fleet as PF
from repro_torch.adapt import forecast as PFC

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fleet import assert_result_equal  # noqa: E402
from test_torch_online import (assert_history_equal, cycle_s,  # noqa: E402
                               default_point, demo, demo_fleet, n_segments)
from _torch_threads import one_torch_thread  # noqa: E402,F401

TABLES = ("centroids", "born", "counts", "stats_sum", "stats_n", "trans",
          "dur_sum", "dur_n", "cur_cluster", "cur_age", "n_obs")


def test_window_features_match():
    d = demo()
    events = np.stack([d.nonstationary_trace(s) for s in (11, 0, 7, 9)])
    events[1] *= 0.5                      # fractional amplitudes
    for t_end, window_s, kw in ((1.0, 8.0, {}), (9.5, 8.0, {}),
                                (60.0, 8.0, dict(n_windows=3)),
                                (30.0, 5.0, dict(n_windows=4, stride_s=2.5,
                                                 n_max=3)),
                                (300.0, 20.0, dict(n_max=5))):
        got = PA.window_features(events, t_end, 1.0, window_s, **kw)
        want = JA.window_features(events, t_end, 1.0, window_s, **kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert PA.FEATURES == JA.FEATURES


def feature_stream(n_steps=12, n_dev=8, n_win=3, seed=0):
    """A seeded ``(steps, D, W, F)`` stream drawn around three regimes, so
    the forecaster spawns clusters, stays and switches."""
    rng = np.random.default_rng(seed)
    regimes = rng.random((3, 6))
    which = rng.integers(0, 3, (n_steps, n_dev, n_win))
    noise = 0.05 * rng.normal(size=(n_steps, n_dev, n_win, 6))
    return np.abs(regimes[which] + noise)


def tables_equal(p, j):
    for name in TABLES:
        a, b = getattr(p, name), getattr(j, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n_clusters,radius", [(4, 0.75), (3, 0.3)])
def test_forecaster_matches_jax(n_clusters, radius):
    """``observe``/``predict`` on a seeded ``(D=8, W=3)`` stream leave the
    same tables and give the same predictions after every batch."""
    j = JA.HarvestForecaster(n_clusters=n_clusters, spawn_radius=radius)
    p = PA.HarvestForecaster(n_clusters=n_clusters, spawn_radius=radius,
                             device="cpu")
    assert p.predict()["eta"].shape == (0,)
    for feats in feature_stream():
        eta, supply = feats[..., 0], 0.06 * feats[..., 2]
        idx_j = j.observe(feats, eta, supply)
        idx_p = p.observe(feats, eta, supply)
        np.testing.assert_array_equal(idx_p, idx_j)
        tables_equal(p, j)
        for horizon in (1.0, 2.5):
            pj, pp = j.predict(horizon), p.predict(horizon)
            assert pp.keys() == pj.keys()
            for k in pj:
                np.testing.assert_array_equal(pp[k], pj[k], err_msg=k)
    assert p.n_born == j.n_born > 1
    # a (D, F) batch returns the last window's cluster per device
    np.testing.assert_array_equal(
        p.observe(feats[:, 0], eta[:, 0], supply[:, 0]),
        j.observe(feats[:, 0], eta[:, 0], supply[:, 0]))
    with pytest.raises(ValueError):
        PA.HarvestForecaster(n_clusters=0)


def test_forecast_arm_on_four_devices_matches_jax(monkeypatch):
    """The demo's forecast arm on four devices (trace seeds 11, 0, 1, 2)
    over one cycle: the seeding runs ``pairwise_l1`` on the first batch,
    and the history and result equal the reference's, fused mode."""
    d = demo()
    seeds = (d.SEED, 0, 1, 2)
    points = [default_point(d.SEED)]
    jcfg, jst, pcfg, pst = demo_fleet(seeds, points)

    def controllers(mod):
        return [mod.EtaController(rho=0.5, window_s=20.0, n_max=4),
                mod.ForecastController(
                    window_s=d.FORECAST_WINDOW_S,
                    horizon_s=d.FORECAST_HORIZON_S, n_clusters=4,
                    supply_window_s=5.0, supply_rho=0.7,
                    e_opt_bounds=(0.05, 0.95), miss_target=0.1)]

    calls = []
    real = PFC.ops.pairwise_l1

    def spy(x, y, **kw):
        calls.append(tuple(x.shape))
        return real(x, y, **kw)

    monkeypatch.setattr(PFC.ops, "pairwise_l1", spy)
    j_ad = JA.OnlineAdapter(jst, jcfg, controllers=controllers(JA))
    ref, _ = JF.run_segments(jcfg, jst, n_segments(), hook=j_ad.hook)
    p_ad = PA.OnlineAdapter(pst, pcfg, controllers=controllers(PA))
    res, _ = PF.run_segments(pcfg, pst, n_segments(), hook=p_ad.hook,
                             mode="fused")
    assert calls == [(len(seeds), len(PA.FEATURES))]
    assert_history_equal(p_ad.history, j_ad.history)
    assert_result_equal(res, ref)
    fc = p_ad.controllers[1].forecaster
    tables_equal(fc, j_ad.controllers[1].forecaster)
    assert fc.device == pcfg.eta.device and fc.n_born > 1
    assert any(bool(h["confidence"].max() > 0) for h in p_ad.history)
    assert cycle_s() == 106.0
