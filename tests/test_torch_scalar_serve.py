"""The port's scalar ``ServeEngine`` against the JAX package, and against
the port's own ``FleetServeEngine``.

Two small agile CNNs (four and three units) are built with the JAX package
from a seed and fitted with its k-means bank; ``repro_torch.convert``
carries the weights and banks across, so both packages serve the same
requests from the same state.

* With each package's own CNN features: every discrete outcome (the
  ``SimResult`` counters, every job record, every unit's pass, prediction
  and correctness) is exact, and the margins agree within the CNN tolerance
  that ``tests/test_torch_serve.py`` uses.
* With the features fixed (a duck model whose units return the JAX CNN's
  features for both packages), the margins are bit-equal too.
* The port's scalar engine equals the port's fleet engine (one device,
  ``feature_batch=1``) bit for bit on the clock-commensurate recipes of
  ``tests/test_fleet_engine.py``: units, exits, schedule, predictions and
  margins, with adaptation on and off, on several devices, and the miss
  sets under overload.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import energy as JE
from repro.core import kmeans as JK
from repro.core.agile import AgileCNN as JAgileCNN
from repro.models import cnn as JC
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine

from repro_torch import convert
from repro_torch.core import energy as PE
from repro_torch.core.agile import AgileCNN
from repro_torch.kernels import ops
from repro_torch.models import cnn as PC
from repro_torch.serve import (FleetServeEngine, Request, ServeConfig,
                               ServeEngine)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_serve import _data  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

SPECS = (("tiny4", (16, 16, 1), ((4, 5, True), (8, 5, True)), (16, 8), 3),
         ("tiny3", (16, 16, 1), ((6, 5, True),), (12, 8), 3))
JOB_FIELDS = ("job_id", "release", "deadline", "unit", "exited_at",
              "last_pred_unit", "mandatory_done_time", "finished")
SIM_FIELDS = ("released", "scheduled", "correct", "deadline_misses",
              "units_executed", "optional_units", "busy_time",
              "idle_no_energy", "reboots", "wasted_reexec", "sim_time")
N_JOBS = 6
CNN_TOL = dict(rtol=1e-5, atol=1e-5)


def build_models():
    """JAX models + fitted banks and their converted port twins (CPU)."""
    xtr, ytr = _data(1, 96)
    jms, pms = [], []
    for i, spec in enumerate(SPECS):
        jcfg = JC.CNNConfig(*spec)
        params = JC.init_cnn_params(jcfg, jax.random.PRNGKey(10 + i))
        feats = [np.asarray(f) for f in
                 JC.cnn_forward_all(jcfg, params, jnp.asarray(xtr))]
        bank = JK.fit_bank(feats, ytr, thresholds=[0.05] * len(feats),
                           seed=i)
        jms.append((jcfg, params, bank))
        pms.append((PC.CNNConfig(*spec),
                    convert.cnn_params(jax.tree.map(np.asarray, params),
                                       "cpu"),
                    convert.bank([jax.tree.map(np.asarray, uc)
                                  for uc in bank], "cpu")))
    return jms, pms


@pytest.fixture(scope="module")
def models():
    return build_models()


def _requests(cls, n=N_JOBS, period=1.0, n_tasks=2):
    xte, yte = _data(2, n_tasks * n)
    return [[cls(xte[k * n + j], int(yte[k * n + j]), release=j * period)
             for j in range(n)] for k in range(n_tasks)]


def _jax_model(models, i, threshold=None):
    cfg, params, bank = models[0][i]
    bank = [uc if threshold is None
            else uc._replace(threshold=jnp.float32(threshold))
            for uc in bank]
    return JAgileCNN(cfg, params, bank)


def _port_model(models, i, threshold=None):
    """A private port AgileCNN (adaptation replaces ``bank`` entries); an
    optional uniform threshold override forces or forbids early exit."""
    cfg, params, bank = models[1][i]
    bank = [uc if threshold is None
            else uc._replace(threshold=torch.tensor(np.float32(threshold)))
            for uc in bank]
    return AgileCNN(cfg, params, bank)


def _config_kw(policy, adapt):
    return dict(policy=policy, period=1.0, deadline=2.5, horizon=N_JOBS + 4.0,
                adapt=adapt, unit_time=np.full(4, 0.25),
                unit_energy=np.full(4, 9e-3), seed=4)


def _harvesters():
    return (JE.Harvester("h", 0.9, 0.9, 0.3),
            PE.Harvester("h", 0.9, 0.9, 0.3))


def _assert_sim_equal(out, ref):
    for f in SIM_FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert type(a) is type(b) and a == b, (f, a, b)
    for f in ("task_released", "task_scheduled", "task_correct",
              "task_misses"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)


def _assert_engines_equal(peng, jeng, margins_exact):
    """Job records and every profile's host arrays equal; margins exact or
    within the CNN tolerance."""
    assert len(peng.jobs_) == len(jeng.jobs_)
    for i, (a, b) in enumerate(zip(peng.jobs_, jeng.jobs_)):
        assert a.task.task_id == b.task.task_id, f"job {i}"
        for f in JOB_FIELDS:
            assert getattr(a, f) == getattr(b, f), f"job {i} {f}"
    for pt, jt in zip(peng.profiles_, jeng.profiles_):
        for j, (p, q) in enumerate(zip(pt, jt)):
            assert p._exec_units == q._exec_units, f"job {j}"
            for f in ("_passes", "_preds", "_correct"):
                np.testing.assert_array_equal(getattr(p, f), getattr(q, f),
                                              err_msg=f"job {j} {f}")
            if margins_exact:
                np.testing.assert_array_equal(p._margins, q._margins,
                                              err_msg=f"job {j} margins")
            else:
                np.testing.assert_allclose(p._margins, q._margins, **CNN_TOL,
                                           err_msg=f"job {j} margins")


@pytest.mark.parametrize("policy,adapt", [("zygarde", True),
                                          ("zygarde", False),
                                          ("edf", True)])
def test_scalar_engine_matches_jax(models, policy, adapt):
    """Each package's own CNN on two tasks under an intermittent harvester:
    every discrete outcome exact, margins within the CNN tolerance."""
    jh, ph = _harvesters()
    jeng = JServeEngine([_jax_model(models, i) for i in range(2)], jh,
                        eta=0.6, config=JServeConfig(**_config_kw(policy,
                                                                  adapt)))
    peng = ServeEngine([_port_model(models, i) for i in range(2)], ph,
                       eta=0.6, config=ServeConfig(**_config_kw(policy,
                                                                adapt)))
    ref = jeng.run(_requests(JRequest))
    before = ops.launch_counts()
    out = peng.run(_requests(Request))
    assert ops.launch_counts() == before     # the CPU launches nothing
    _assert_sim_equal(out, ref)
    _assert_engines_equal(peng, jeng, margins_exact=False)
    assert out.units_executed > 0 and out.scheduled > 0
    if adapt:
        exited = [p for t in peng.profiles_ for p in t if p._exited]
        assert exited, "no job passed its utility test: nothing adapted"


class _FixedFeatures:
    """Duck agile model: unit ``u`` of request ``i`` returns ``feats[i][u]``
    (the JAX CNN's own features) as the package's array type, so both
    packages classify the same f32 rows.  ``Request.x`` is the index."""

    def __init__(self, feats, bank, to_array, device=None):
        self.feats, self.bank, self._to = feats, list(bank), to_array
        self.device = device

    @property
    def n_units(self) -> int:
        return len(self.bank)

    def _initial_state(self, x):
        return int(x)

    def _run_unit(self, state, u):
        return state, self._to(self.feats[state][u])


def _jax_unit_features(model, xs):
    """The JAX CNN's per-unit features, one request at a time."""
    out = []
    for x in xs:
        state, row = model._initial_state(x), []
        for u in range(model.n_units):
            state, f = model._run_unit(state, u)
            row.append(np.array(f, np.float32))
        out.append(row)
    return out


@pytest.mark.parametrize("policy", ["zygarde", "edf-m", "rr"])
def test_scalar_engine_bit_equal_with_fixed_features(models, policy):
    """The same features on both sides (adaptation off): margins bit-equal,
    and with them every outcome."""
    jh, ph = _harvesters()
    jreqs = _requests(JRequest)
    jduck, pduck, streams = [], [], []
    for i in range(2):
        feats = _jax_unit_features(_jax_model(models, i),
                                   [r.x for r in jreqs[i]])
        jduck.append(_FixedFeatures(feats, models[0][i][2], jnp.asarray))
        pduck.append(_FixedFeatures(feats, models[1][i][2],
                                    torch.from_numpy, torch.device("cpu")))
        streams.append([(j, r.label, r.release)
                        for j, r in enumerate(jreqs[i])])
    kw = _config_kw(policy, False)
    jeng = JServeEngine(jduck, jh, eta=0.6, config=JServeConfig(**kw))
    peng = ServeEngine(pduck, ph, eta=0.6, config=ServeConfig(**kw))
    ref = jeng.run([[JRequest(*r) for r in s] for s in streams])
    out = peng.run([[Request(*r) for r in s] for s in streams])
    _assert_sim_equal(out, ref)
    _assert_engines_equal(peng, jeng, margins_exact=True)
    assert out.units_executed > 0


def test_scalar_engine_rejects_models_on_two_devices(models):
    a = _port_model(models, 0)
    b = _FixedFeatures([], models[1][1][2], torch.from_numpy,
                       torch.device("meta"))
    with pytest.raises(ValueError, match="devices"):
        ServeEngine([a, b], _harvesters()[1], eta=0.6)


# --------------------------------------------------------------------------- #
# The port's scalar engine == the port's fleet engine.
# --------------------------------------------------------------------------- #


def _persistent():
    return PE.Harvester("battery", 1.0, 0.0, 1.0)


def _cfg(policy, n, adapt, period=2.0, deadline=1.5):
    """The clock-commensurate parity recipe: dt = 0.05 divides the 0.2 s
    units, releases and deadlines; charged persistent power removes the
    energy gate's dependence on harvest-sample timing."""
    return ServeConfig(policy=policy, period=period, deadline=deadline,
                       horizon=n * period + 2.0, adapt=adapt,
                       start_charged=True, sim_dt=0.05)


def _scalar_run(models, cfg, reqs, threshold):
    eng = ServeEngine([_port_model(models, 0, threshold)], _persistent(),
                      eta=1.0, config=cfg)
    res = eng.run([reqs])
    jobs = eng.jobs_
    units = np.array([j.unit for j in jobs])
    sched = np.array([0 <= j.mandatory_done_time <= j.deadline
                      for j in jobs])
    profs = eng.profiles_[0]
    pred = np.array([p._preds[u - 1] if u > 0 else -1
                     for p, u in zip(profs, units)])
    margin = np.array([p._margins[u - 1] if u > 0 else 0.0
                       for p, u in zip(profs, units)], np.float32)
    return res, units, sched, pred, margin


def _fleet_run(models, cfg, reqs, threshold, n_devices=1, **kw):
    eng = FleetServeEngine([_port_model(models, 0, threshold)],
                           _persistent(), eta=1.0, config=cfg,
                           feature_batch=1, device="cpu")
    return eng.run([reqs], n_devices=n_devices, **kw)


@pytest.mark.parametrize("policy", ["zygarde", "edf"])
@pytest.mark.parametrize("adapt", [False, True])
def test_scalar_matches_fleet(models, policy, adapt):
    """One device, the fleet == the scalar engine bit for bit: units,
    exits, schedule, predictions and margins.  ``adapt=True`` lowers the
    bank thresholds so every job exits early and adapts the centroids;
    under EDF adaptation still fires at the first bank pass."""
    n = 6
    thr = 0.02 if adapt else None
    cfg = _cfg(policy, n, adapt)
    reqs = _requests(Request, n, cfg.period, 1)[0]
    res, units, sched, pred, margin = _scalar_run(models, cfg, reqs, thr)
    fres = _fleet_run(models, cfg, reqs, thr)
    np.testing.assert_array_equal(units, fres.units[0, 0, :n])
    np.testing.assert_array_equal(sched, fres.sched[0, 0, :n])
    np.testing.assert_array_equal(pred, fres.pred[0, 0, :n])
    np.testing.assert_array_equal(margin.view(np.uint32),
                                  fres.margin[0, 0, :n].view(np.uint32))
    f = fres.fleet
    assert res.scheduled == int(f.scheduled[0])
    assert res.correct == int(f.correct[0])
    assert res.deadline_misses == int(f.deadline_misses[0])
    assert res.units_executed == int(f.units_executed[0])
    if adapt:
        assert (fres.exit_unit[0, 0, :n] >= 0).all()


def test_scalar_matches_fleet_many_devices(models):
    """Four devices on the same stream: every device reproduces the scalar
    run (per-device banks adapt independently from the same start)."""
    n = 5
    cfg = _cfg("zygarde", n, True)
    reqs = _requests(Request, n, cfg.period, 1)[0]
    _, units, sched, pred, margin = _scalar_run(models, cfg, reqs, 0.02)
    fres = _fleet_run(models, cfg, reqs, 0.02, n_devices=4)
    for d in range(4):
        np.testing.assert_array_equal(units, fres.units[d, 0, :n])
        np.testing.assert_array_equal(sched, fres.sched[d, 0, :n])
        np.testing.assert_array_equal(pred, fres.pred[d, 0, :n])
        np.testing.assert_array_equal(margin.view(np.uint32),
                                      fres.margin[d, 0, :n].view(np.uint32))


def test_fleet_device_margins_do_not_depend_on_the_fleet_size(models):
    """One device's margins in a one-device fleet equal every device's in
    a four-device fleet on the same stream, bit for bit: each adapting
    device's centroid propagation runs on its own rows, whatever the
    number of devices adapting in the step."""
    n = 5
    cfg = _cfg("zygarde", n, True)
    reqs = _requests(Request, n, cfg.period, 1)[0]
    one = _fleet_run(models, cfg, reqs, 0.02)
    four = _fleet_run(models, cfg, reqs, 0.02, n_devices=4)
    assert (one.exit_unit[0, 0, :n] >= 0).all()
    for d in range(4):
        np.testing.assert_array_equal(one.margin[0, 0, :n].view(np.uint32),
                                      four.margin[d, 0, :n].view(np.uint32))


@pytest.mark.parametrize("threshold", [None, 10.0])
def test_scalar_fleet_miss_sets_under_overload(models, threshold):
    """A deadline tighter than full execution (0.7 s against 0.8 s of
    units): both engines agree on which jobs miss.  With the utility test
    disabled (threshold 10) nothing exits early, so every job misses."""
    n = 5
    cfg = _cfg("zygarde", n, False, period=1.0, deadline=0.7)
    reqs = _requests(Request, n, cfg.period, 1)[0]
    res, _, sched, _, _ = _scalar_run(models, cfg, reqs, threshold)
    fres = _fleet_run(models, cfg, reqs, threshold)
    np.testing.assert_array_equal(sched, fres.sched[0, 0, :n])
    assert res.deadline_misses == int(fres.fleet.deadline_misses[0])
    if threshold == 10.0:
        assert not sched.any()
        assert res.deadline_misses == n
