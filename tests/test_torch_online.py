"""The port's runtime adaptation loop (``repro_torch.adapt.online``) against
the JAX package ``repro.adapt.online``.

The estimators and the per-segment measurements are host-side numpy in
both packages and must agree exactly; ``OnlineAdapter`` over
``run_segments`` on one cycle (106 s) of ``examples/online_adapt.py``'s
nonstationary solar -> RF -> occluded trace must write the same history
(every key, every array) and end in the same ``FleetResult``, in the
port's vmap and fused modes.  All bit for bit.
"""
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import adapt as JA
from repro import fleet as JF
from repro.core import energy as JE
from repro.fleet import grid as jgrid

from repro_torch import adapt as PA
from repro_torch import fleet as PF
from repro_torch import telemetry as PT

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fleet import (assert_result_equal, port_cfg,  # noqa: E402
                              port_statics)
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=1)
def demo():
    """``examples/online_adapt.py`` as a module (its workload and trace)."""
    path = ROOT / "examples" / "online_adapt.py"
    spec = importlib.util.spec_from_file_location("online_adapt_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cycle_s() -> float:
    d = demo()
    return float(d.SOLAR_S + d.RF_S + d.OCC_S)


def demo_fleet(trace_seeds, points, horizon=None):
    """One device per (trace seed, (eta, e_opt fraction)) on the demo's
    task and capacitor, over ``horizon`` (default: one cycle); the JAX
    config and statics and the port's."""
    d = demo()
    horizon = cycle_s() if horizon is None else horizon
    task = d.make_task()
    cap = JE.Capacitor(capacitance_f=d.CAPACITANCE_F)
    harv = JE.Harvester("nonstationary", 0.5, 0.5, d.P_ON)
    devices = [jgrid.device_config(task, harv, eta, cap, policy="zygarde",
                                   horizon=horizon,
                                   events=d.nonstationary_trace(s),
                                   e_opt_fraction=frac)
               for s in trace_seeds for eta, frac in points]
    cfg = jgrid.stack_configs(devices)
    statics = JF.FleetStatics(queue_size=3, dt=0.025, horizon=horizon,
                              slot_s=1.0)
    return cfg, statics, port_cfg(cfg), port_statics(statics)


def default_point(seed):
    d = demo()
    events = d.nonstationary_trace(seed)
    eta0 = max(JE.eta_factor((events > 0).astype(np.int8)), 0.05)
    return (eta0, JA.PAPER_E_OPT_FRACTION)


def assert_history_equal(port, ref):
    assert len(port) == len(ref) and len(ref) > 0
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.keys() == b.keys(), i
        for k in b:
            if b[k] is None or np.isscalar(b[k]):
                assert a[k] == b[k], (i, k)
            else:
                assert a[k].dtype == b[k].dtype, (i, k)
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"entry {i}: {k}")


# --------------------------------------------------------------------------- #
# Estimators and measurements.
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,kw", [("ewma", dict(rho=0.3)),
                                     ("ewma", dict(rho=1.0)),
                                     ("quantile", dict(q=0.5, window=4)),
                                     ("quantile", dict(q=0.8, window=9))])
def test_estimators_match(name, kw):
    rng = np.random.default_rng(5)
    j, p = JA.ESTIMATORS[name](**kw), PA.ESTIMATORS[name](**kw)
    for _ in range(20):
        m = rng.random(7)
        np.testing.assert_array_equal(p.update(m), j.update(m))
    assert sorted(PA.ESTIMATORS) == sorted(JA.ESTIMATORS)
    with pytest.raises(ValueError):
        PA.EwmaEstimator(rho=0.0)
    with pytest.raises(ValueError):
        PA.EtaController(estimator="nope")


def test_observed_statistics_match():
    """``observed_eta``, ``observed_supply``, ``workload_demand`` and
    ``miss_rate`` on the demo's traces and a half-cycle carry."""
    d = demo()
    events = np.stack([d.nonstationary_trace(s) for s in (11, 3, 4)])
    power = np.array([0.06, 0.05, 0.08], np.float32)
    for t_end in (0.5, 1.0, 7.5, 40.0, 106.0, 400.0):
        for window_s, n_max in ((20.0, 4), (3.0, 5), (0.5, 2)):
            np.testing.assert_array_equal(
                PA.observed_eta(events, t_end, 1.0, window_s, n_max),
                JA.observed_eta(events, t_end, 1.0, window_s, n_max))
            np.testing.assert_array_equal(
                PA.observed_supply(events, power, t_end, 1.0, window_s),
                JA.observed_supply(events, power, t_end, 1.0, window_s))
    jcfg, jst, pcfg, pst = demo_fleet(
        (11, 3), [(0.4, 0.3), (0.9, 0.8)], horizon=cycle_s() / 2)
    for a, b in zip(PA.workload_demand(pcfg), JA.workload_demand(jcfg)):
        np.testing.assert_array_equal(a, b)
    half = JF.FleetStatics(3, 0.025, cycle_s() / 4, 1.0)
    _, jc1 = JF.run_segments(jcfg, half, 1)
    _, jc2 = JF.run_segments(jcfg, jst, 1, carry=jc1,
                             start_step=half.n_steps)
    _, pc1 = PF.run_segments(pcfg, port_statics(half), 1)
    _, pc2 = PF.run_segments(pcfg, pst, 1, carry=pc1,
                             start_step=half.n_steps, mode="fused")
    np.testing.assert_array_equal(PA.miss_rate(pc2, pc1),
                                  JA.miss_rate(jc2, jc1))
    np.testing.assert_array_equal(PA.miss_rate(pc2, None),
                                  JA.miss_rate(jc2, None))


# --------------------------------------------------------------------------- #
# The adapter over run_segments.
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=1)
def jax_feedback_cycle():
    """The demo's feedback arm on its default point over one cycle, JAX."""
    d = demo()
    jcfg, jst, _, _ = demo_fleet((d.SEED,), [default_point(d.SEED)])
    adapter = JA.OnlineAdapter(jst, jcfg, **feedback_kw())
    res, _ = JF.run_segments(jcfg, jst, n_segments(), hook=adapter.hook)
    return res, adapter.history


def feedback_kw():
    return dict(rho=0.5, window_s=20.0, n_max=4, supply_window_s=5.0,
                supply_rho=0.7, e_opt_bounds=(0.05, 0.95), miss_target=0.1)


def n_segments() -> int:
    return int(cycle_s() / demo().SEGMENT_S)


@pytest.mark.parametrize("mode", ["vmap", "fused"])
def test_online_adapter_matches_jax(mode):
    """The feedback arm (``EtaController`` + ``FeedbackController``) over
    one cycle: the same history and the same result in both modes."""
    d = demo()
    ref, ref_hist = jax_feedback_cycle()
    _, _, pcfg, pst = demo_fleet((d.SEED,), [default_point(d.SEED)])
    adapter = PA.OnlineAdapter(pst, pcfg, **feedback_kw())
    res, _ = PF.run_segments(pcfg, pst, n_segments(), hook=adapter.hook,
                             mode=mode)
    assert_history_equal(adapter.history, ref_hist)
    assert_result_equal(res, ref)
    assert adapter.eta_hat.shape == (1,)
    assert len({round(float(h["eta_hat"][0]), 6)
                for h in adapter.history}) > 3      # the estimate moved


def test_hook_updates_are_tensors_on_the_config_device():
    """The hook hands ``run_segments`` contiguous tensors of the config's
    dtypes on its device; given a telemetry summary it measures the miss
    rate from the summary's delta (the carry diff's rate) and returns the
    same kind of tensors."""
    d = demo()
    _, _, pcfg, pst = demo_fleet((d.SEED, 4), [default_point(d.SEED)],
                                 horizon=10.0)
    adapter = PA.OnlineAdapter(pst, pcfg)
    carry = PF.init_fleet(pcfg, pst)
    new = adapter.hook(0, 5.0, pcfg, carry)
    for f in ("eta", "e_opt", "persistent"):
        a, b = getattr(new, f), getattr(pcfg, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.device == b.device and a.is_contiguous(), f
    _, carry2, tel = PF.run_segments(pcfg, pst, 1,
                                     telemetry=PT.TelemetryConfig())
    summary = PT.summarize(tel, 10.0)
    fresh = PA.OnlineAdapter(pst, pcfg)
    new2 = fresh.hook(0, 10.0, pcfg, carry2, telemetry=summary)
    ref = PA.OnlineAdapter(pst, pcfg)
    ref.hook(0, 10.0, pcfg, carry2)
    np.testing.assert_array_equal(fresh.history[0]["miss_rate"],
                                  ref.history[0]["miss_rate"])
    np.testing.assert_array_equal(fresh.history[0]["miss_rate"],
                                  summary.miss_rate)
    for f in ("eta", "e_opt", "persistent"):
        a, b = getattr(new2, f), getattr(pcfg, f)
        assert a.dtype == b.dtype and a.device == b.device, f
