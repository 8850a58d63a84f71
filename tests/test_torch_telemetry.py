"""The port's telemetry (``repro_torch.telemetry``, the step core's trace
branches and ``telemetry=`` through the replay fleet and the online
adapter) against the JAX package on the CPU.

The grid is ``tests/test_telemetry.py``'s: 16 intermittently powered
devices with misses, power failures and reboots.  The claims, as the
reference states them for itself:

1. Telemetry changes no bit of the simulation: every ``FleetResult`` and
   carry leaf equals the plain run's, at both tiers and in the ``vmap``
   and ``pallas`` modes.
2. The port's telemetry equals JAX's: the integer fields exactly, the
   float fields at ``tests/test_telemetry.py``'s tolerances (1e-4 for
   ``slack_sum``, ``energy_sum`` and ``ring_val``, 1e-6 otherwise).  The
   port forms the end-of-step clock and the slack term as one rounding
   and sums the steps in XLA's window-32 order, as the compiled reference
   does; the gap measured here is zero on every field.
3. The collection paths equal the reference fold of ``record_step`` at
   every step, and the ring keeps the newest events slot for slot when it
   overflows.
4. The summary, its JSONL stream and the report's text equal JAX's; the
   online adapter reads the same miss rates from the summary as from the
   carry.
"""
import io
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import fleet as JF
from repro.core import energy as JE
from repro.core import step as JS
from repro.fleet import simulator as JSim
from repro import telemetry as JT
from repro.telemetry import report as j_report
from repro.telemetry import trace as j_trace

from repro_torch import convert
from repro_torch import fleet as PF
from repro_torch import telemetry as PT
from repro_torch.core import step as PS
from repro_torch.fleet import simulator as PSim
from repro_torch.telemetry import report as p_report
from repro_torch.telemetry import trace as p_trace

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _workloads import make_task  # noqa: E402
from test_torch_fleet import (assert_result_equal, port_cfg,  # noqa: E402
                              port_statics)
from _torch_threads import one_torch_thread  # noqa: E402,F401

#: telemetry fields that must be integer-exact (tests/test_telemetry.py)
INT_FIELDS = ("c_release", "c_miss", "c_sched", "c_retired", "c_power_fail",
              "c_reboot", "c_knob", "exit_hist", "occ_sum", "occ_max",
              "n_steps", "ring_kind", "ring_head")
#: the fields the "counters" tier collects
COUNTER_FIELDS = ("c_release", "c_miss", "c_sched", "c_reboot",
                  "c_power_fail", "occ_sum", "occ_max", "energy_sum",
                  "energy_min", "n_steps")
MODES = ("vmap", "pallas")
LEVELS = ("counters", "full")


def _grid(horizon=6.0, seeds=(0, 1)):
    """``tests/test_telemetry.py:_grid``: 16 devices on an RF harvester."""
    return JF.SweepGrid(
        task=make_task(n_jobs=10),
        policies=("zygarde", "edf"),
        etas=(0.5, 0.9),
        harvesters=(JE.Harvester("rf", 0.93, 0.93, 0.07),),
        capacitors=(JE.Capacitor(capacitance_f=0.01),
                    JE.Capacitor(capacitance_f=0.05)),
        seeds=seeds,
        horizon=horizon,
    )


@pytest.fixture(scope="module")
def built():
    cfg, statics, _ = JF.build(_grid())
    return cfg, statics, port_cfg(cfg), port_statics(statics)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_tel_close(port, ref, fields=None):
    """Integer fields exact, floats at the reference's tolerances; the
    dtypes equal."""
    for f in fields or ref._fields:
        a, b = _host(getattr(port, f)), _host(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f in ("slack_sum", "energy_sum", "ring_val"):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f)


def _tcfg(level, ring_size=32):
    return (JT.TelemetryConfig(ring_size=ring_size, level=level),
            PT.TelemetryConfig(ring_size=ring_size, level=level))


# --------------------------------------------------------------------- #
# The static pieces: the pack layout, the config.
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n_tasks,queue_size,n_bins",
                         [(1, 3, 5), (2, 3, 5), (3, 8, 9), (4, 1, 2),
                          (7, 16, 33), (5, 255, 64)])
def test_make_pack_spec_matches_jax(n_tasks, queue_size, n_bins):
    assert p_trace.make_pack_spec(n_tasks, queue_size, n_bins).__dict__ \
        == j_trace.make_pack_spec(n_tasks, queue_size, n_bins).__dict__


def test_pack_spec_and_config_reject_what_the_reference_rejects():
    for mod in (j_trace, p_trace):
        with pytest.raises(ValueError, match="4 bits"):
            mod.make_pack_spec(8, 3, 5)
    for bad in (dict(ring_size=0), dict(level="debug")):
        with pytest.raises(ValueError):
            PT.TelemetryConfig(**bad)
    assert PT.EVENT_KINDS == JT.EVENT_KINDS
    assert PT.EVENT_NAMES == JT.EVENT_NAMES


# --------------------------------------------------------------------- #
# The folds on the same random inputs.
# --------------------------------------------------------------------- #


def _random_events(rng, D, Q):
    """One step's StepEvents of ``D`` devices, as numpy."""
    return dict(
        releases=rng.integers(0, 3, D).astype(np.int32),
        misses=rng.integers(0, 3, D).astype(np.int32) * (rng.random(D) < .4),
        scheduled=rng.integers(0, 3, D).astype(np.int32),
        retired=rng.random((D, Q)) < 0.3,
        slack=rng.normal(0.0, 2.0, (D, Q)).astype(np.float32),
        exit_depth=rng.integers(-1, 6, (D, Q)).astype(np.int32),
        power_fail=rng.random(D) < 0.2,
        reboots=(rng.random(D) < 0.2).astype(np.int32),
        queue_occ=rng.integers(0, Q + 1, D).astype(np.int32),
        energy=rng.random(D).astype(np.float32),
    )


@pytest.mark.parametrize("ring_size", [4, 16])
def test_record_step_matches_jax(ring_size):
    """40 steps of random events folded by both ``record_step``s: every
    field equal, the ring slot for slot (it overflows at both sizes)."""
    rng = np.random.default_rng(ring_size)
    D, Q, U = 6, 3, 4
    jt, pt = _tcfg("full", ring_size)
    jtel = jax.vmap(lambda _: JT.init_telemetry(jt, U))(jnp.arange(D))
    ptel = PT.init_telemetry(pt, U, (D,), "cpu")
    jfold = jax.jit(jax.vmap(JT.record_step, in_axes=(0, 0, None)))
    for i in range(40):
        ev = _random_events(rng, D, Q)
        t = np.float32(i) * np.float32(0.025)
        jtel = jfold(jtel, JS.StepEvents(**ev), t)
        ptel = PT.record_step(ptel, PS.StepEvents(
            **{k: torch.from_numpy(np.asarray(v)) for k, v in ev.items()}),
            torch.tensor(t))
    assert int(np.asarray(jtel.ring_head).max()) > ring_size
    assert_tel_close(ptel, jtel)
    for f in INT_FIELDS + ("ring_t", "energy_min", "slack_min"):
        np.testing.assert_array_equal(_host(getattr(ptel, f)),
                                      _host(getattr(jtel, f)), err_msg=f)


def test_record_anytime_step_and_knob_updates_match_jax():
    """One device's anytime folds and a fleet's host-pushed knob updates:
    every field equal."""
    rng = np.random.default_rng(3)
    U = 5
    jt, pt = _tcfg("full", 8)
    jtel = JT.init_telemetry(jt, U)
    ptel = PT.init_telemetry(pt, U, device="cpu")
    for i in range(30):
        retired = int(rng.integers(0, 3))
        misses = int(rng.integers(0, retired + 1))
        slack = rng.normal(0.0, 1.0, retired).astype(np.float32)
        kw = dict(releases=int(rng.integers(0, 3)), misses=misses,
                  scheduled=retired - misses, retired=retired,
                  slack_sum=np.float32(slack.sum()),
                  slack_min=np.float32(slack.min() if retired else np.inf),
                  depth_hist=rng.integers(0, 3, U + 1).astype(np.int32),
                  occupancy=int(rng.integers(0, 4)),
                  energy=np.float32(rng.random()),
                  t=np.float32(0.1 * (i + 1)))
        jtel = JT.record_anytime_step(jtel, **kw)
        ptel = PT.record_anytime_step(
            ptel, **{k: torch.tensor(v) for k, v in kw.items()})
    assert int(jtel.ring_head) > 8
    assert_tel_close(ptel, jtel)

    D = 5
    jf = jax.vmap(lambda _: JT.init_telemetry(jt, U))(jnp.arange(D))
    pf = PT.init_telemetry(pt, U, (D,), "cpu")
    for k in range(12):
        changed = rng.random(D) < 0.5
        t_end = 0.3 * (k + 1)
        jf = JT.record_knob_updates(jf, changed, t_end)
        pf = PT.record_knob_updates(pf, changed, t_end)
    assert_tel_close(pf, jf)


# --------------------------------------------------------------------- #
# The step core's trace words.
# --------------------------------------------------------------------- #


def _jax_stages(statics):
    """The JAX stages with ``trace=True`` over the device axis (jitted,
    as the reference's scans run them)."""
    v = jax.vmap
    admit = jax.jit(v(lambda c, s, t: JS.admit(c, s, t, statics,
                                               trace=True),
                      in_axes=(0, 0, None)))
    expire = jax.jit(v(lambda c, s, t, a0: JS.drop_expired(
        c, s, t, trace=True, q_active_pre=a0), in_axes=(0, 0, None, 0)))
    pick = jax.jit(v(lambda c, s, t: JS.pick(c, s, t, statics),
                     in_axes=(0, 0, None)))
    apply = jax.jit(v(lambda c, s, t, a, p, r, e, a0, te: JS.apply_step(
        c, s, t, a, p, r, e, statics, trace=True, q_active_pre=a0,
        t_end=te), in_axes=(0, 0, None, 0, 0, 0, 0, 0, None)))
    return admit, expire, pick, apply


def _assert_words(port, ref, what):
    for f, a, b in zip(port._fields if hasattr(port, "_fields")
                       else range(len(ref)), port, ref):
        a, b = _host(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f"{what} {f}")


def _overflow_fleet():
    """Two tasks on two queue slots, released faster than they run: new
    jobs arrive while exited jobs still run optional units, so the queue
    evicts (and drops where nothing is evictable)."""
    import dataclasses

    import _workloads as W

    tasks = [make_task(n_jobs=14, period=0.25, deadline=1.0, exit_at=0),
             dataclasses.replace(make_task(n_jobs=9, period=0.4,
                                           deadline=1.2, exit_at=1),
                                 task_id=1)]
    grid = JF.SweepGrid(task=tasks,
                        policies=("zygarde", "edf", "edf-m", "rr"),
                        etas=(0.5, 1.0),
                        harvesters=(W.MODES["persistent"][0],
                                    W.MODES["intermittent"][0]),
                        horizon=4.0, queue_size=2)
    cfg, statics, _ = JF.build(grid)
    return cfg, statics, port_cfg(cfg), port_statics(statics)


@pytest.mark.parametrize("workload", ["grid", "overflow"])
def test_trace_words_match_jax(built, workload):
    """Every step through ``admit`` -> ``drop_expired`` -> ``pick`` ->
    ``apply_step`` with ``trace=True``, and ``device_step``'s trace: the
    carry and every descriptor word equal JAX's bit for bit, and the
    traced carry equals the plain transition's.  The grid expires jobs;
    the one-slot fleet of two tasks evicts them."""
    cfg, statics, pcfg, pst = built if workload == "grid" \
        else _overflow_fleet()
    admit, expire, pick, apply = _jax_stages(statics)
    jst = JSim.init_fleet(cfg, statics)
    pst_ = PF.init_fleet(pcfg, pst)
    n_evict = n_expire = n_complete = 0
    for i in range(statics.n_steps):
        t = np.float32(i) * np.float32(statics.dt)
        te = np.float32(i + 1) * np.float32(statics.dt)
        tp = PS.step_clock(i, pst.dt, "cpu")
        tep = PS.step_clock(i + 1, pst.dt, "cpu")
        a0 = jst.q_active
        js1, jw1 = admit(cfg, jst, t)
        ps1, pw1 = PS.admit(pcfg, pst_, tp, pst, trace=True)
        _assert_words(pw1, jw1, f"admit step {i}")
        js2, jw2 = expire(cfg, js1, t, a0)
        ps2, pw2 = PS.drop_expired(pcfg, ps1, tp, trace=True,
                                   q_active_pre=pst_.q_active)
        _assert_words(pw2, jw2, f"drop_expired step {i}")
        sel, picked, run, e_new = pick(cfg, js2, t)
        psel = PS.pick(pcfg, ps2, tp, pst)
        js3, jw3 = apply(cfg, js2, t, sel, picked, run, e_new, a0, te)
        ps3, pw3 = PS.apply_step(pcfg, ps2, tp, *psel, pst, t_end=tep,
                                 trace=True, q_active_pre=pst_.q_active)
        _assert_words(pw3, jw3, f"apply_step step {i}")
        _assert_words(ps3, js3, f"carry step {i}")
        ps4, ptr = PS.device_step(pcfg, pst_, tp, pst, t_end=tep, trace=True)
        _assert_words(ptr, (*jw1, *jw2, *jw3), f"device_step step {i}")
        _assert_words(ps4, js3, f"device_step carry step {i}")
        plain = PS.device_step(pcfg, pst_, tp, pst, t_end=tep)
        for f, a, b in zip(plain._fields, plain, ps4):
            assert torch.equal(a, b), f"traced carry {f} step {i}"
        n_evict += int((pw1[1] > 0).sum())
        n_expire += int((pw2[0] > 0).sum())
        n_complete += int((pw3[0] > 0).sum())
        jst, pst_ = js3, ps4
    assert n_complete and (n_expire if workload == "grid" else n_evict), (
        n_evict, n_expire, n_complete)


def test_step_events_match_jax(built):
    """``step_events`` over the grid's steps equals JAX's on every field:
    with ``t`` an argument of the jitted function, ``t + dt`` is two
    roundings there and here (the telemetry's reference fold, where XLA
    contracts it, is held in ``test_collection_matches_reference_fold``)."""
    cfg, statics, pcfg, pst = built
    jev = jax.jit(jax.vmap(lambda s0, s1, t: JS.step_events(s0, s1, t,
                                                            statics),
                           in_axes=(0, 0, None)))
    jstep = jax.jit(jax.vmap(lambda c, s, t, te: JS.device_step(
        c, s, t, statics, t_end=te), in_axes=(0, 0, None, None)))
    jst, pst_ = JSim.init_fleet(cfg, statics), PF.init_fleet(pcfg, pst)
    for i in range(0, statics.n_steps):
        t = np.float32(i) * np.float32(statics.dt)
        te = np.float32(i + 1) * np.float32(statics.dt)
        js1 = jstep(cfg, jst, t, te)
        ps1 = PS.device_step(pcfg, pst_, PS.step_clock(i, pst.dt, "cpu"),
                             pst, t_end=PS.step_clock(i + 1, pst.dt, "cpu"))
        if i % 7 == 0:
            ref = jev(jst, js1, t)
            out = PS.step_events(pst_, ps1, PS.step_clock(i, pst.dt, "cpu"),
                                 pst)
            _assert_words(out, ref, f"step_events step {i}")
        jst, pst_ = js1, ps1


# --------------------------------------------------------------------- #
# The fleet frontends.
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("mode", MODES)
def test_simulate_fleet_matches_jax(built, mode, level):
    """``simulate_fleet(telemetry=)``: the result equals the plain run's
    and JAX's, the telemetry JAX's."""
    cfg, statics, pcfg, pst = built
    jt, pt = _tcfg(level)
    jres, jtel = JF.simulate_fleet(cfg, statics, telemetry=jt, mode=mode)
    pres, ptel = PF.simulate_fleet(pcfg, pst, telemetry=pt, mode=mode)
    assert_result_equal(pres, jres)
    plain = PF.simulate_fleet(pcfg, pst, mode=mode)
    for f, a, b in zip(plain._fields, plain, pres):
        assert torch.equal(a, b), f
    assert_tel_close(ptel, jtel)
    assert int(ptel.n_steps[0]) == pst.n_steps
    if level == "full":
        assert int(ptel.c_retired.sum()) > 0 and int(ptel.ring_head.max())
    else:
        init = PT.init_fleet_telemetry(pt, pcfg)
        for f in ("c_retired", "slack_sum", "slack_min", "exit_hist",
                  "ring_head", "ring_kind"):
            assert torch.equal(getattr(ptel, f), getattr(init, f)), f


def _resume_hook(log):
    def hook(seg, t_end, c, carry, telemetry=None):
        log.append(telemetry)
        return c._replace(eta=c.eta * 0.99) if seg == 0 else None
    return hook


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_segments", [1, 3])
def test_run_segments_matches_jax(built, n_segments, mode, level):
    """``run_segments(telemetry=)`` with a hook that declares ``telemetry=``
    and rewrites eta after the first segment: the hook's summaries, the
    knob-update stamps, the result, the carry and the telemetry equal
    JAX's; the carry equals the plain hooked run's."""
    cfg, statics, pcfg, pst = built
    jt, pt = _tcfg(level)
    jseen, pseen = [], []
    jres, jcarry, jtel = JF.run_segments(
        cfg, statics, n_segments, hook=_resume_hook(jseen), telemetry=jt,
        mode=mode)
    pres, pcarry, ptel = PF.run_segments(
        pcfg, pst, n_segments, hook=_resume_hook(pseen), telemetry=pt,
        mode=mode)
    assert_result_equal(pres, jres)
    assert_tel_close(ptel, jtel)
    assert len(pseen) == n_segments and all(s is not None for s in pseen)
    for a, b in zip(pseen, jseen):
        assert a.as_dict(per_device=True) == b.as_dict(per_device=True)
    if n_segments > 1:
        assert int(ptel.c_knob.sum()) == pcfg.n_devices
    _, plain = PF.run_segments(pcfg, pst, n_segments,
                               hook=_resume_hook([]), mode=mode)
    for f, a, b in zip(plain._fields, plain, pcarry):
        assert torch.equal(a, b), f


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("mode", MODES)
def test_telemetry_carry_resumes_a_jax_run(built, mode, level):
    """The first half on JAX, its carry and telemetry converted, the second
    half resumed in the port: equal to JAX's whole run."""
    cfg, statics, pcfg, pst = built
    jt, pt = _tcfg(level)
    half = statics.n_steps // 2
    jres, _, jtel = JF.run_segments(cfg, statics, 2, telemetry=jt)
    _, jc1, jt1 = JF.run_segments(
        cfg, JF.FleetStatics(statics.queue_size, statics.dt,
                             half * statics.dt, statics.slot_s),
        1, telemetry=jt)
    pres, _, ptel = PF.run_segments(
        pcfg, pst, 1, carry=convert.device_carry(_np(jc1), "cpu"),
        start_step=half, telemetry=pt,
        telemetry_carry=convert.telemetry(_np(jt1), "cpu"), mode=mode)
    assert_result_equal(pres, jres)
    assert_tel_close(ptel, jtel)
    back = JT.Telemetry(**convert.to_numpy(ptel))
    assert_tel_close(ptel, back)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("n_segments", [1, 3])
def test_collection_matches_reference_fold(built, level, n_segments):
    """The port's collection paths == its own ``record_step`` fold at
    every step (the reference's claim), and that fold == JAX's fold."""
    cfg, statics, pcfg, pst = built
    jt, pt = _tcfg(level, 64)
    tel = ref = PT.init_fleet_telemetry(pt, pcfg)
    st = sr = PF.init_fleet(pcfg, pst)
    i0 = 0
    for n in (len(c) for c in np.array_split(np.arange(pst.n_steps),
                                             n_segments)):
        st, tel = PSim._run_steps_tel(pcfg, st, tel, i0, pst, n, "vmap", pt)
        sr, ref = PSim._run_steps_tel_reference(pcfg, sr, ref, i0, pst, n,
                                                "vmap")
        i0 += n
    for f, a, b in zip(st._fields, st, sr):
        assert torch.equal(a, b), f
    if level == "full":
        assert_tel_close(tel, ref)
    else:
        assert_tel_close(tel, ref, COUNTER_FIELDS)
    jinit = JT.init_fleet_telemetry(jt, cfg)
    _, jref = JSim._scan_steps_tel_reference(
        cfg, JSim.init_fleet(cfg, statics), jinit, jnp.int32(0), statics,
        statics.n_steps, False, jt)
    _, pref = PSim._run_steps_tel_reference(
        pcfg, PF.init_fleet(pcfg, pst), PT.init_fleet_telemetry(pt, pcfg), 0,
        pst, pst.n_steps, "vmap")
    assert_tel_close(pref, jref)


@pytest.mark.parametrize("mode", MODES)
def test_ring_overflow_keeps_latest(built, mode):
    """A ring of 4 overflows: the head counts every push and the buffer
    holds the newest events, slot for slot as JAX's and as the reference
    fold's."""
    cfg, statics, pcfg, pst = built
    jt, pt = _tcfg("full", 4)
    _, jtel = JF.simulate_fleet(cfg, statics, telemetry=jt, mode=mode)
    _, ptel = PF.simulate_fleet(pcfg, pst, telemetry=pt, mode=mode)
    assert int(ptel.ring_head.max()) > 4
    assert_tel_close(ptel, jtel, ("ring_head", "ring_kind", "ring_t",
                                  "ring_val", "exit_hist"))
    _, ref = PSim._run_steps_tel_reference(
        pcfg, PF.init_fleet(pcfg, pst), PT.init_fleet_telemetry(pt, pcfg), 0,
        pst, pst.n_steps, mode)
    assert_tel_close(ptel, ref, ("ring_head", "ring_kind", "ring_t",
                                 "ring_val"))


def test_fused_mode_rejects_telemetry(built):
    _, _, pcfg, pst = built
    pt = PT.TelemetryConfig()
    with pytest.raises(ValueError, match="fused"):
        PF.simulate_fleet(pcfg, pst, telemetry=pt, mode="fused")
    with pytest.raises(ValueError, match="fused"):
        PF.run_segments(pcfg, pst, 2, telemetry=pt, mode="fused")
    with pytest.raises(ValueError, match="telemetry_carry"):
        PF.run_segments(pcfg, pst, 2, telemetry_carry=object())


# --------------------------------------------------------------------- #
# Export, JSONL and the report.
# --------------------------------------------------------------------- #


def _logged_run(run_segments, cfg, statics, tcfg, logger_cls, path):
    summaries = []
    with logger_cls(path, label="unit_test", per_device=True) as log:
        log.meta(statics, tcfg, n_devices=cfg.n_devices)

        def hook(seg, t_end, c, carry, telemetry=None):
            summaries.append(telemetry)
            log.segment(seg, telemetry)
            return c._replace(eta=c.eta * 0.99) if seg == 0 else None

        _, _, tel = run_segments(cfg, statics, n_segments=3, hook=hook,
                                 telemetry=tcfg)
        n_events = log.drain_rings(tel)
    return summaries, tel, n_events


def test_summary_jsonl_and_report_match_jax(built, tmp_path):
    """A hooked three-segment run logged by both packages: the summaries
    (``summarize``, ``delta``, ``as_dict``), the JSONL records and the
    report's text are equal."""
    cfg, statics, pcfg, pst = built
    jt, pt = _tcfg("full")
    js, jtel, jn = _logged_run(JF.run_segments, cfg, statics, jt,
                               JT.TelemetryLogger, tmp_path / "j.jsonl")
    ps, ptel, pn = _logged_run(PF.run_segments, pcfg, pst, pt,
                               PT.TelemetryLogger, tmp_path / "p.jsonl")
    assert pn == jn > 0
    for a, b in zip(ps, js):
        for f in b.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.as_dict(True) == b.as_dict(True)
        assert a.delta(js[0]).as_dict() == b.delta(js[0]).as_dict()
    final = PT.summarize(ptel, pst.horizon)
    assert final.as_dict() == JT.summarize(jtel, statics.horizon).as_dict()
    recs = PT.read_jsonl(tmp_path / "p.jsonl")
    assert recs == JT.read_jsonl(tmp_path / "j.jsonl")
    assert any(r["event"] == "knob_update" for r in recs)
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    for kw in (dict(), dict(cohorts=8, width=64)):
        a, b = io.StringIO(), io.StringIO()
        p_report.render(tmp_path / "p.jsonl", out=a, **kw)
        j_report.render(tmp_path / "j.jsonl", out=b, **kw)
        assert a.getvalue() == b.getvalue() and "unit_test" in a.getvalue()


def test_report_cli_prints_the_reference_text(built, tmp_path):
    """``python -m repro_torch.telemetry.report <jsonl>`` prints what the
    reference's report prints for the same file (its ``render``, called in
    this process: ``python -m repro.telemetry.report`` stops at a circular
    import of ``repro.telemetry.state`` when it runs as ``__main__``)."""
    import os
    import subprocess

    cfg, statics, pcfg, pst = built
    _, pt = _tcfg("full")
    _logged_run(PF.run_segments, pcfg, pst, pt, PT.TelemetryLogger,
                tmp_path / "p.jsonl")
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               JAX_PLATFORMS="cpu")
    ours = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.report",
         str(tmp_path / "p.jsonl"), "--cohorts", "3"],
        capture_output=True, text=True, env=env, check=True).stdout
    ref = io.StringIO()
    j_report.render(tmp_path / "p.jsonl", out=ref, cohorts=3)
    assert ours == ref.getvalue() and "exit-depth" in ours


# --------------------------------------------------------------------- #
# The online adapter reads the summary.
# --------------------------------------------------------------------- #


def test_online_adapter_with_telemetry_matches_jax():
    """The demo's feedback arm over one cycle with ``telemetry=``: the
    history equals JAX's with telemetry and the port's own carry-diff run,
    and every observation carries the segment's summary."""
    from repro import adapt as JA
    from repro_torch import adapt as PA
    from test_torch_online import (demo, demo_fleet, default_point,
                                   assert_history_equal, feedback_kw,
                                   n_segments)

    d = demo()
    jcfg, jst, pcfg, pst = demo_fleet((d.SEED, 3), [default_point(d.SEED)])
    jt, pt = _tcfg("counters", 8)
    jad = JA.OnlineAdapter(jst, jcfg, **feedback_kw())
    jres, _, _ = JF.run_segments(jcfg, jst, n_segments(), hook=jad.hook,
                                 telemetry=jt)
    seen = []

    class Watch(PA.Controller):
        def update(self, obs):
            seen.append(obs.telemetry)
            return {}, {}

    pad = PA.OnlineAdapter(pst, pcfg, **feedback_kw())
    pad.controllers.append(Watch())
    pres, pcarry, _ = PF.run_segments(pcfg, pst, n_segments(),
                                      hook=pad.hook, telemetry=pt)
    assert_history_equal(pad.history, jad.history)
    assert_result_equal(pres, jres)
    plain = PA.OnlineAdapter(pst, pcfg, **feedback_kw())
    PF.run_segments(pcfg, pst, n_segments(), hook=plain.hook)
    assert_history_equal(pad.history, plain.history)
    # the controllers saw each segment's delta: they add up to the carry
    assert len(seen) == n_segments() and all(s is not None for s in seen)
    assert sum(int(s.releases.sum()) for s in seen) == int(
        pcarry.next_rel.sum())
    assert sum(int(s.misses.sum()) for s in seen) == int(
        pcarry.m_misses.sum())
