"""The port's event-driven scheduler loop against the JAX package.

``repro_torch.core.scheduler.simulate`` is host code, a python event loop
over numpy profiles, written to match ``repro.core.scheduler.simulate`` bit
for bit: the same f64 priorities (Eqs. 6-7 on python floats) and the same
random draws in the same order.  The workloads are ``tests/_workloads.py``'s
seeded task sets; the port's ``TaskSpec`` twins hold the same numpy arrays.
Every ``SimResult`` field, every per-task array and every ``Job`` record
must be equal with ``==``, floats included.  Against the port's fixed-step
``simulate_stepped`` the loop keeps the calibrated bounds that
``tests/test_parity.py`` holds the JAX package to.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_fallback import given, settings, st

from repro.core import scheduler as JS
from repro.core.scheduler import JobProfile as JJobProfile

from repro_torch.core import scheduler as PS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _workloads as W  # noqa: E402
from test_torch_fleet import port_harvester, port_tasks  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

POLICIES = ("zygarde", "edf", "edf-m", "rr")
JOB_FIELDS = ("job_id", "release", "deadline", "unit", "exited_at",
              "last_pred_unit", "mandatory_done_time", "finished")


def _clock(name, pkg):
    return pkg.CHRTClock() if name == "chrt" else pkg.Clock()


def _run_both(tasks, mode, **sim_kw):
    """JAX's and the port's ``simulate`` on the same task set and config
    (the clock by name, each package its own)."""
    harv, eta = W.MODES[mode]
    clock = sim_kw.pop("clock", "rtc")
    ref = JS.simulate(tasks, harv, eta,
                      sim=JS.SimConfig(clock=_clock(clock, JS), **sim_kw))
    out = PS.simulate(port_tasks(tasks), port_harvester(harv), eta,
                      sim=PS.SimConfig(clock=_clock(clock, PS), **sim_kw))
    return out, ref


def _assert_same(out, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)
    assert out.as_dict() == ref.as_dict()
    assert len(out.jobs) == len(ref.jobs)
    for i, (a, b) in enumerate(zip(out.jobs, ref.jobs)):
        assert a.task.task_id == b.task.task_id, f"job {i}"
        for f in JOB_FIELDS:
            assert getattr(a, f) == getattr(b, f), f"job {i} {f}"


@pytest.mark.parametrize("k", sorted(W.TASK_SET_SEEDS))
@pytest.mark.parametrize("mode", sorted(W.MODES))
@pytest.mark.parametrize("pol", POLICIES)
def test_simulate_matches_jax(pol, mode, k):
    """The parity matrix of ``tests/test_parity.py``: every policy, both
    harvester modes, one, two and four tasks."""
    tasks = W.random_task_set(W.TASK_SET_SEEDS[k], k)
    out, ref = _run_both(tasks, mode, policy=pol, horizon=W.HORIZON, seed=3)
    _assert_same(out, ref)
    assert out.units_executed > 0


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("start_charged", [False, True])
def test_simulate_chrt_clock_matches_jax(pol, start_charged):
    """The CHRT remanence clock draws once per queue sweep and per off-wait
    step: one draw out of order would move every later result."""
    tasks = W.random_task_set(W.TASK_SET_SEEDS[2], 2)
    out, ref = _run_both(tasks, "intermittent", policy=pol,
                         horizon=W.HORIZON, seed=5, clock="chrt",
                         start_charged=start_charged)
    _assert_same(out, ref)


@pytest.mark.parametrize("mode", sorted(W.MODES))
@pytest.mark.parametrize("start_charged", [False, True])
def test_simulate_release_jitter_matches_jax(mode, start_charged):
    """Jittered releases: one uniform draw per release, in task order."""
    tasks = [dataclasses.replace(t, release_jitter=0.4)
             for t in W.random_task_set(W.TASK_SET_SEEDS[4], 4)]
    for pol in POLICIES:
        out, ref = _run_both(tasks, mode, policy=pol, horizon=W.HORIZON,
                             seed=7, start_charged=start_charged)
        _assert_same(out, ref)


@pytest.mark.parametrize("queue_size", [1, 2])
@pytest.mark.parametrize("pol", POLICIES)
def test_simulate_queue_overflow_matches_jax(pol, queue_size):
    """A short queue under four tasks: overflow drops and, for jobs whose
    mandatory part is done, eviction in favour of the new arrival."""
    tasks = W.random_task_set(W.TASK_SET_SEEDS[4], 4)
    out, ref = _run_both(tasks, "persistent", policy=pol, horizon=W.HORIZON,
                         seed=1, queue_size=queue_size)
    _assert_same(out, ref)
    # the queue overflowed: some job missed without ever running a unit
    assert any(j.unit == 0 and not j.mandatory_met for j in out.jobs)


def _job_pair(deadline, margins, last_pred, exited_at):
    """A JAX and a port ``Job`` over the same profile and state."""
    n = len(margins)
    prof = (np.asarray(margins, np.float64), np.zeros(n, bool),
            np.zeros(n, bool))
    jobs = []
    for pkg, prof_cls in ((JS, JJobProfile), (PS, PS.JobProfile)):
        task = pkg.TaskSpec(0, 1.0, 2.0, np.full(n, 0.1), np.full(n, 1e-3),
                            [prof_cls(*prof)])
        jobs.append(pkg.Job(task, 0, 0.0, deadline, prof_cls(*prof),
                            last_pred_unit=last_pred, exited_at=exited_at))
    return jobs


@given(st.floats(0.0, 50.0), st.floats(0.0, 50.0),
       st.lists(st.floats(-1.0, 1.0), min_size=1, max_size=6),
       st.integers(-1, 5), st.integers(-1, 5), st.floats(0.01, 5.0),
       st.floats(0.0, 2.0), st.floats(0.0, 1.0), st.floats(0.0, 0.5),
       st.floats(0.0, 0.5))
@settings(max_examples=200, deadline=None)
def test_zeta_matches_jax(deadline, t_now, margins, last_pred, exited_at,
                          alpha, beta, eta, e_curr, e_opt):
    """Eqs. 6-7 on python floats equal the reference's scalar priorities
    exactly (no f32 rounding anywhere)."""
    last_pred = min(last_pred, len(margins) - 1)
    jj, pj = _job_pair(deadline, margins, last_pred, exited_at)
    a = PS.zeta(pj, t_now, alpha, beta)
    b = JS.zeta(jj, t_now, alpha, beta)
    assert type(a) is float and a == b
    a = PS.zeta_intermittent(pj, t_now, alpha, beta, eta, e_curr, e_opt)
    b = JS.zeta_intermittent(jj, t_now, alpha, beta, eta, e_curr, e_opt)
    assert type(a) is float and a == b


@pytest.mark.parametrize("pol,mode,k", [("zygarde", "intermittent", 2),
                                        ("rr", "persistent", 1)])
def test_simulate_within_bound_of_stepped(pol, mode, k):
    """The event-driven loop vs the port's fixed-step frontend: the release
    schedule exact, the per-task outcomes within ``per_task_bound`` (as
    ``tests/test_parity.py`` holds JAX), jobs conserved on both sides."""
    tasks = port_tasks(W.random_task_set(W.TASK_SET_SEEDS[k], k))
    harv, eta = W.MODES[mode]
    harv = port_harvester(harv)
    sim = PS.SimConfig(policy=pol, horizon=W.HORIZON, seed=3)
    scalar = PS.simulate(tasks, harv, eta, sim=sim)
    stepped = PS.simulate_stepped(tasks, harv, eta, sim=sim, dt=W.DT,
                                  device="cpu")
    np.testing.assert_array_equal(scalar.task_released,
                                  stepped.task_released)
    assert scalar.released == stepped.released
    bound = W.per_task_bound(scalar.task_released, mode)
    for name in ("scheduled", "correct", "misses"):
        s = getattr(scalar, f"task_{name}")
        f = getattr(stepped, f"task_{name}")
        assert (np.abs(s - f) <= bound).all(), (name, s, f, bound)
    for r in (scalar, stepped):
        np.testing.assert_array_equal(r.task_scheduled + r.task_misses,
                                      r.task_released)
