"""``telemetry=`` through the port's serving engines against the JAX
package on the CPU: ``FleetServeEngine.run`` at both tiers and both bank
modes and ``run_stream`` at the counters tier (the anytime engine's is in
``tests/test_torch_telemetry_anytime.py``).

Each package serves the same requests with its own CNN features (the
serve suites show the discrete outcomes equal JAX's), so the telemetry —
a function of those outcomes, the deadlines and the capacitor — is held
to JAX's: integer fields exactly, floats at ``tests/test_telemetry.py``'s
tolerances.  Within the port the serve outcome with telemetry equals the
plain run's bit for bit, and a stream's counters equal the monolithic
run's over the same segment bounds bit for bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from repro.core import energy as JE
from repro.serve import FleetServeEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro import telemetry as JT   # after repro.serve (an import cycle)

from repro_torch import telemetry as PT
from repro_torch.serve import Request

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_telemetry import assert_tel_close  # noqa: E402
from test_torch_serve import (_jax_engine, _port_engine,  # noqa: E402,F401
                              _requests, _streams, models)
import test_torch_stream as TS  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

_LOG_FIELDS = ("units", "pred", "correct", "margin", "exit_unit", "sched")


def _tcfg(level, ring_size=16):
    return (JT.TelemetryConfig(ring_size=ring_size, level=level),
            PT.TelemetryConfig(ring_size=ring_size, level=level))


def _assert_outcome_equal(a, b):
    """Two port serve results: logs, fleet counters and carry bit-equal."""
    for f in _LOG_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f, x, y in zip(a.fleet._fields, a.fleet, b.fleet):
        assert torch.equal(x, y), f"fleet.{f}"
    for part in ("dev", "bank", "log"):
        pa, pb = getattr(a.carry, part), getattr(b.carry, part)
        for f, x, y in zip(pa._fields, pa, pb):
            assert torch.equal(x, y), f"{part}.{f}"


@pytest.mark.parametrize("level", ["counters", "full"])
@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_serve_run_telemetry_matches_jax(models, bank_mode, level):
    """``run(telemetry=)`` with adaptation on, in two segments: the outcome
    equals the port's plain run, the telemetry JAX's."""
    jt, pt = _tcfg(level)
    jreqs = _requests(JRequest, _streams(False), False)
    preqs = _requests(Request, _streams(False), False)
    jres = _jax_engine(models, "zygarde", True, bank_mode).run(
        jreqs, n_devices=3, n_segments=2, telemetry=jt)
    peng = _port_engine(models, "zygarde", True, bank_mode)
    pres = peng.run(preqs, n_devices=3, n_segments=2, telemetry=pt)
    plain = _port_engine(models, "zygarde", True, bank_mode).run(
        preqs, n_devices=3, n_segments=2)
    _assert_outcome_equal(pres, plain)
    assert plain.telemetry is None
    assert_tel_close(pres.telemetry, jres.telemetry)
    tel = pres.telemetry
    assert int(tel.c_release.sum()) == pres.jobs
    assert (tel.n_steps == tel.n_steps[0]).all()
    if level == "full":
        assert int(tel.c_retired.sum()) > 0 and int(tel.ring_head.sum()) > 0
        assert int(tel.exit_hist[:, :-1].sum()) > 0     # early exits seen


def test_serve_run_rejects_fused_telemetry(models):
    eng = _port_engine(models, "zygarde", False, "per-device")
    reqs = _requests(Request, _streams(False), False)
    with pytest.raises(ValueError, match="fused"):
        eng.run(reqs, 1, telemetry=PT.TelemetryConfig(), mode="fused")


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_run_stream_counters_match_run_and_jax(bank_mode):
    """``run_stream(telemetry=counters)`` in 3 chunks: the outcome equals
    the plain stream's, the counters equal ``run``'s over the same 3
    segments bit for bit, and JAX's ``run_stream``'s."""
    models = TS.build_models()
    n, total = 4, 9
    jt, pt = _tcfg("counters")
    cfg = TS._cfg("zygarde", total, adapt=True)
    reqs = TS._reqs(n)

    def eng():
        return TS._engine(models, cfg, 0.02, bank_mode=bank_mode)

    st = eng().run_stream([reqs], n_devices=2, total_jobs=total,
                          n_chunks=3, telemetry=pt)
    plain = eng().run_stream([reqs], n_devices=2, total_jobs=total,
                             n_chunks=3)
    TS._assert_same_outcome(st, plain, jobs=total)
    repeated = [Request(reqs[i % n].x, reqs[i % n].label,
                        release=i * cfg.period) for i in range(total)]
    mono = eng().run([repeated], n_devices=2, n_segments=3, telemetry=pt)
    for f in st.telemetry._fields:
        a, b = getattr(st.telemetry, f), getattr(mono.telemetry, f)
        assert torch.equal(a, b), f
    jeng = JEngine([TS._jax_model(models, 0, 0.02)],
                   JE.Harvester("battery", 1.0, 0.0, 1.0), eta=1.0,
                   config=TS._cfg("zygarde", total, True, cls=JServeConfig),
                   feature_batch=1, bank_mode=bank_mode)
    ref = jeng.run_stream([TS._requests(JRequest, n, 2.0, 1)[0]],
                          n_devices=2, total_jobs=total, n_chunks=3,
                          telemetry=jt)
    assert_tel_close(st.telemetry, ref.telemetry)
    assert int(st.telemetry.c_release.sum()) == st.jobs == 2 * total


def test_run_stream_rejects_full_tier_and_fused():
    models = TS.build_models()
    eng = TS._engine(models, TS._cfg("zygarde", 2, adapt=False))
    reqs = TS._reqs(2)
    with pytest.raises(ValueError, match="counters"):
        eng.run_stream([reqs], n_devices=1,
                       telemetry=PT.TelemetryConfig(level="full"))
    with pytest.raises(ValueError, match="telemetry"):
        eng.run_stream([reqs], n_devices=1, mode="fused",
                       telemetry=PT.TelemetryConfig())
