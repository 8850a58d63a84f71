"""The port's offline tuning (``repro_torch.adapt``: space, drivers,
objective) against the JAX package ``repro.adapt``.

The search space and the search drivers are numpy copies: the same rng calls in
the same order give an identical ``history`` and ``best_params``.
``apply_params`` threads the same values into the same config leaves, and
``TuneProblem.objective()`` — one fused fleet run per call in the port,
one jitted program in the reference — gives the same float32 scores on
every candidate, so ``tune`` takes the same path.  All bit for bit.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import adapt as JA
from repro.core import energy as JE
from repro.core.scheduler import CHRTClock, JobProfile, TaskSpec
from repro.core.utility import scalarized_objective as j_scalarized

from repro_torch import adapt as PA
from repro_torch import convert
from repro_torch.core.utility import scalarized_objective as p_scalarized
from repro_torch.launch.mesh import make_fleet_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fleet import port_harvester, port_tasks  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

DRIVERS = ("random", "grid", "es", "es-grad", "cma")


def make_task(n_jobs=12, n_units=4, exit_at=1, correct_from=2, task_id=0,
              period=1.0, deadline=2.0):
    """``tests/test_adapt.py``'s workload with accuracy headroom: the
    utility test passes after unit ``exit_at`` but predictions are correct
    only from unit ``correct_from``."""
    margins = np.linspace(0.05, 0.5, n_units)
    passes = np.zeros(n_units, bool)
    passes[exit_at:] = True
    correct = np.zeros(n_units, bool)
    correct[correct_from:] = True
    prof = JobProfile(margins, passes, correct)
    return TaskSpec(task_id=task_id, period=period, deadline=deadline,
                    unit_time=np.full(n_units, 0.1),
                    unit_energy=np.full(n_units, 8e-3),
                    profiles=[prof] * n_jobs)


HARVESTERS = (JE.Harvester("solar", 0.95, 0.95, 0.08),
              JE.Harvester("rf", 0.85, 0.85, 0.05),
              JE.Harvester("piezo", 0.90, 0.90, 0.06))


def problems(n_harvesters=2, seeds=(0, 1), **kw):
    """The same two-harvester x two-seed, 10 s problem in both packages
    (the capacitor starts charged, so a short horizon still scores)."""
    tasks = kw.pop("tasks", make_task())
    kw.setdefault("start_charged", True)
    multi = not isinstance(tasks, TaskSpec)
    harvesters = HARVESTERS[:n_harvesters]
    j = JA.TuneProblem(task=tasks, harvesters=harvesters, seeds=seeds,
                       horizon=10.0, **kw)
    p = PA.TuneProblem(task=port_tasks(tasks if multi else [tasks]),
                       harvesters=tuple(port_harvester(h)
                                        for h in harvesters),
                       seeds=seeds, horizon=10.0, device="cpu", **kw)
    return j, p


def two_tasks():
    return (make_task(task_id=0, period=0.8, deadline=1.2),
            make_task(task_id=1, period=1.6, deadline=4.0))


# --------------------------------------------------------------------------- #
# Space and drivers.
# --------------------------------------------------------------------------- #


def test_space_sample_grid_clip_identical():
    bounds = dict(eta=(0.05, 1.0), e_opt_fraction=(0.05, 0.95),
                  n_clusters=(2, 5.5, int))
    js, ps = JA.SearchSpace.of(**bounds), PA.SearchSpace.of(**bounds)
    assert [tuple(vars(p).values()) for p in ps.params] == [
        tuple(vars(p).values()) for p in js.params]
    np.testing.assert_array_equal(ps.sample(np.random.default_rng(3), 37),
                                  js.sample(np.random.default_rng(3), 37))
    for budget in (1, 8, 60, 200):
        np.testing.assert_array_equal(ps.grid(budget), js.grid(budget))
    x = np.random.default_rng(4).uniform(-1, 7, size=(50, 3))
    np.testing.assert_array_equal(ps.clip(x), js.clip(x))
    np.testing.assert_array_equal(ps.clip(x[0]), js.clip(x[0]))
    for a, b in zip(ps.to_dict(x).values(), js.to_dict(x).values()):
        np.testing.assert_array_equal(a, b)


def quadratic(params):
    """A numpy landscape with a correlated optimum and an integer knob."""
    x, y, n = params["x"], params["y"], params["n"]
    return -((x - 0.3) ** 2 + 2 * (y - 0.6 + 0.5 * (x - 0.3)) ** 2
             + 0.1 * (n - 3) ** 2)


@pytest.mark.parametrize("driver", DRIVERS)
def test_drivers_identical_on_quadratic(driver):
    bounds = dict(x=(0.0, 1.0), y=(0.0, 1.0), n=(1, 6, int))
    kw = dict(budget=77, driver=driver, seed=5, pop_size=12)
    jr = JA.tune(quadratic, JA.SearchSpace.of(**bounds), **kw)
    pr = PA.tune(quadratic, PA.SearchSpace.of(**bounds), **kw)
    assert pr.best_params == jr.best_params
    assert pr.history == jr.history
    assert (pr.best_score, pr.n_evals, pr.driver) == (
        jr.best_score, jr.n_evals, jr.driver)
    assert sorted(PA.DRIVERS) == sorted(JA.DRIVERS)
    with pytest.raises(KeyError):
        PA.tune(quadratic, PA.SearchSpace.of(**bounds), 4, driver="nope")


# --------------------------------------------------------------------------- #
# apply_params and the objective.
# --------------------------------------------------------------------------- #


def test_apply_params_matches_jax():
    """Every recognised name threads the same values into the same leaves
    (``persistent`` narrowed by the tuned eta)."""
    jp, pp = problems(tasks=two_tasks())
    jbase, _ = jp._base
    pbase, _ = pp._base
    for f, a, b in zip(pbase._fields, pbase, jbase):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    d = jbase.n_devices
    rng = np.random.default_rng(0)
    cases = [
        {"eta": np.array([0.3, 1.0, 1.2, 0.99], np.float32)[:d]},
        {"eta": np.float32(1.0)},
        {"e_opt_fraction": rng.random(d).astype(np.float32)},
        {"exit_threshold": rng.random(d).astype(np.float32)},
        {"exit_thr_2": rng.random(d).astype(np.float32)},
        {"exit_thr_t1": rng.random(d).astype(np.float32)},
        {"exit_thr_t0_u3": rng.random(d).astype(np.float32),
         "exit_thr_1": rng.random(d).astype(np.float32),
         "eta": rng.random(d).astype(np.float32)},
    ]
    jpers = jbase._replace(persistent=jnp.ones_like(jbase.persistent))
    ppers = pbase._replace(persistent=torch.ones_like(pbase.persistent))
    for params in cases:
        for jb, pb in ((jbase, pbase), (jpers, ppers)):
            jc = JA.apply_params(jb, {k: jnp.asarray(v)
                                      for k, v in params.items()})
            pc = PA.apply_params(pb, params)
            for f, a, b in zip(pc._fields, pc, jc):
                assert a.is_contiguous(), f
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{params.keys()} {f}")
    with pytest.raises(KeyError):
        PA.apply_params(pbase, {"nope": np.zeros(d, np.float32)})
    with pytest.raises(KeyError):
        PA.apply_params(pbase, {"exit_thr_x": np.zeros(d, np.float32)})


def population(n, seed=0, extra=()):
    rng = np.random.default_rng(seed)
    params = {"eta": rng.uniform(0.05, 1.0, n),
              "e_opt_fraction": rng.uniform(0.05, 0.95, n)}
    for name in extra:
        params[name] = rng.uniform(0.0, 0.6, n)
    return params


PENALTIES = dict(miss_weight=1.5, optional_weight=0.25)


@pytest.mark.parametrize("case", [
    "plain", "task_weights", "clock_drift", "penalties",
    "task_weights_penalties", "two_tasks_penalties", "six_cells_penalties",
    "six_cells_miss", "sixteen_cells_penalties"])
def test_objective_matches_jax(case):
    """An odd population of 5 (padded to 8 in both packages) scores the
    same in the port's fused fleet run as in the reference's jitted
    program: one task and two, per-task weights, CHRT drift, the miss and
    optional-unit penalties, at 4 and 16 cells (the one-task cell sum is
    vectorised there) and at 6 (summed in order)."""
    kw, extra = {}, ()
    if case.startswith("task_weights"):
        kw = dict(tasks=two_tasks(), task_weights=(0.9, 0.3))
        extra = ("exit_thr_t1", "exit_thr_t0_u2")
    elif case == "clock_drift":
        kw = dict(clock_drift=CHRTClock().equivalent_drift(10.0))
        extra = ("exit_threshold",)
    elif case == "two_tasks_penalties":
        kw = dict(tasks=two_tasks())
    elif case.startswith("six_cells"):
        kw = dict(n_harvesters=3)
    elif case.startswith("sixteen_cells"):
        kw = dict(seeds=tuple(range(8)))
    if case.endswith("penalties"):
        kw.update(PENALTIES)
    elif case.endswith("miss"):
        kw.update(miss_weight=0.7)
    jp, pp = problems(**kw)
    params = population(5, seed=5, extra=extra)
    want = jp.objective()(params)
    got = pp.objective()(params)
    assert got.dtype == want.dtype == np.float32 and got.shape == (5,)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1          # the candidates differ
    assert pp.score(pp.default_params()) == jp.score(jp.default_params())
    assert pp.default_params() == jp.default_params()
    cells = 6 if "six_" in case else 16 if "sixteen" in case else 4
    assert pp.n_cells == jp.n_cells == cells


def test_tune_es_identical():
    jp, pp = problems()
    space = dict(eta=(0.05, 1.0), e_opt_fraction=(0.05, 0.95))
    jr = JA.tune(jp.objective(), JA.SearchSpace.of(**space), budget=32,
                 driver="es", seed=0)
    pr = PA.tune(pp.objective(), PA.SearchSpace.of(**space), budget=32,
                 driver="es", seed=0)
    assert pr.best_params == jr.best_params
    assert pr.history == jr.history and pr.best_score == jr.best_score


def test_unported_options_raise():
    """``mesh=`` runs: on a one-device mesh the objective equals the one
    without a mesh bit for bit (the many-device mesh against the
    reference's 4-device run: ``tests/test_torch_fleet_mesh.py``); a
    ``task_weights`` of the wrong length is the reference's ValueError."""
    base = PA.TuneProblem(task=port_tasks([make_task()]),
                          harvesters=(port_harvester(HARVESTERS[0]),),
                          horizon=5.0, device="cpu")
    x = {"eta": np.linspace(0.1, 1.0, 3, dtype=np.float32)}
    one = dataclasses.replace(base, mesh=make_fleet_mesh(device="cpu"))
    np.testing.assert_array_equal(one.objective()(x), base.objective()(x))
    p = PA.TuneProblem(task=port_tasks([make_task()]),
                       harvesters=(port_harvester(HARVESTERS[0]),),
                       task_weights=(1.0, 2.0), device="cpu")
    with pytest.raises(ValueError, match="task_weights"):
        p._base


# --------------------------------------------------------------------------- #
# Scalarization.
# --------------------------------------------------------------------------- #


def test_scalarized_objective_matches_jax():
    rng = np.random.default_rng(7)
    correct = rng.integers(0, 50, 64).astype(np.int32)
    released = rng.integers(0, 60, 64).astype(np.int32)
    misses = rng.integers(0, 20, 64).astype(np.int32)
    opt = rng.integers(0, 90, 64).astype(np.int32)
    units = rng.integers(0, 200, 64).astype(np.int32)
    for kw in ({}, dict(miss_weight=1.5), dict(optional_weight=0.3),
               dict(miss_weight=0.7, optional_weight=0.1)):
        want = np.asarray(j_scalarized(correct, released, misses, opt, units,
                                       **kw))
        got = p_scalarized(torch.from_numpy(correct),
                           torch.from_numpy(released),
                           torch.from_numpy(misses), torch.from_numpy(opt),
                           torch.from_numpy(units), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
    assert float(p_scalarized(10.0, 20.0)) == float(j_scalarized(10.0, 20.0))
    assert np.isfinite(float(p_scalarized(0.0, 0.0)))
    with pytest.raises(ValueError):
        p_scalarized(1.0, 2.0, optional_units=1.0, optional_weight=0.5)


def test_calibrate_thresholds_match_jax():
    """The threshold sweep classifies through the port's ``l1_topk2`` (its
    plain version here) and picks the same threshold off the same curve
    as the reference, per unit of a bank."""
    from repro.core import kmeans as jkm
    from repro.core.utility import calibrate_bank_thresholds as j_bank
    from repro.core.utility import calibrate_threshold as j_calib

    from repro_torch.core.utility import calibrate_bank_thresholds as p_bank
    from repro_torch.core.utility import calibrate_threshold as p_calib

    rng = np.random.default_rng(11)
    centers = rng.normal(size=(3, 40))
    y = rng.integers(0, 3, 150)
    feats = [(c * centers[y] + rng.normal(size=(150, 40))).astype(np.float32)
             for c in (0.6, 1.2)]
    bank = jkm.fit_bank([f[:100] for f in feats], y[:100], n_sel=12)
    pbank = convert.bank([jax.tree.map(np.asarray, uc) for uc in bank],
                         "cpu")
    for juc, puc, f in zip(bank, pbank, feats):
        want = j_calib(juc, f[100:], y[100:], min_accuracy=0.9)
        got = p_calib(puc, f[100:], y[100:], min_accuracy=0.9)
        assert got == want
    jout = j_bank(bank, [f[100:] for f in feats], y[100:])
    pout = p_bank(pbank, [f[100:] for f in feats], y[100:])
    for j, p in zip(jout, pout):
        assert p.threshold.dtype == torch.float32
        assert float(p.threshold) == float(j.threshold)
