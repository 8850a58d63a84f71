"""The PyTorch port's replay fleet simulator against the JAX package.

The workloads are ``tests/_workloads.py``'s seeded task sets, built by the
JAX package's grid builders and carried into the port as numpy arrays.  The
reference is the JAX code as it runs: ``simulate_fleet(mode="vmap")`` and
``simulate_stepped``, both compiled by XLA on the CPU.  Every result leaf
must be bit-equal, over the parity matrix of ``tests/test_parity.py::
test_stepped_fleet_parity_bit_exact`` (policy x harvester mode x task-set
size).  This file holds the port's ``vmap`` mode and the scalar frontend;
``test_torch_fleet_modes.py`` the kernel modes (through the kernels' plain
versions on CPU tensors) and ``test_torch_fleet_segments.py`` the
segmented runner and the grid builders.  The helpers here are shared with
both.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from repro import fleet as JF
from repro.core.scheduler import SimConfig
from repro.core.scheduler import simulate_stepped as j_simulate_stepped

from repro_torch import convert
from repro_torch import fleet as PF
from repro_torch.core import energy as PE
from repro_torch.core import scheduler as PS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _workloads as W  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

POLICIES = ("zygarde", "edf", "edf-m", "rr")
SHORT = W.HORIZON / 3


def port_statics(statics) -> PF.FleetStatics:
    return PF.FleetStatics(statics.queue_size, statics.dt, statics.horizon,
                           statics.slot_s)


def port_cfg(cfg) -> PF.FleetConfig:
    return convert.step_params(jax.tree.map(np.asarray, cfg), "cpu")


def port_tasks(tasks):
    """The JAX TaskSpecs as the port's (the same numpy data)."""
    return [PS.TaskSpec(t.task_id, t.period, t.deadline, t.unit_time,
                        t.unit_energy,
                        [PS.JobProfile(p.margins, p.passes, p.correct)
                         for p in t.profiles],
                        t.fragments_per_unit, t.release_jitter)
            for t in tasks]


def port_harvester(h) -> PE.Harvester:
    return PE.Harvester(h.name, h.p_stay_on, h.p_stay_off, h.power_on,
                        h.slot_s)


def matrix_cfg(k, horizon=W.HORIZON, policies=POLICIES):
    """One device per (policy, harvester mode) of the parity matrix, each
    built by ``from_sim_config`` as the JAX parity test builds it."""
    tasks = W.random_task_set(W.TASK_SET_SEEDS[k], k)
    cfgs = []
    for mode in sorted(W.MODES):
        harv, eta = W.MODES[mode]
        for pol in policies:
            sim = SimConfig(policy=pol, horizon=horizon, seed=3)
            cfg, statics = JF.from_sim_config(tasks, harv, eta, sim=sim,
                                              dt=W.DT)
            cfgs.append(jax.tree.map(np.asarray, cfg))
    cfg = jax.tree.map(lambda *xs: np.concatenate(xs), *cfgs)
    return jax.tree.map(jax.numpy.asarray, cfg), statics


def assert_result_equal(port, ref, what=""):
    assert port._fields == ref._fields
    for f, a, b in zip(port._fields, port, ref):
        b = np.asarray(b)
        a = a.numpy()
        assert a.dtype == b.dtype, f"{what}{f}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}{f}")


@pytest.mark.parametrize("k", sorted(W.TASK_SET_SEEDS))
def test_simulate_fleet_matches_jax(k):
    """The port's ``vmap`` mode == JAX ``simulate_fleet(mode="vmap")`` on
    every result leaf over the whole horizon, for all four policies under
    both harvester modes (the kernel modes: test_torch_fleet_modes.py)."""
    cfg, statics = matrix_cfg(k)
    ref = JF.simulate_fleet(cfg, statics)
    out = PF.simulate_fleet(port_cfg(cfg), port_statics(statics))
    assert_result_equal(out, ref, "vmap: ")
    assert int(out.units_executed.sum()) > 0


@pytest.mark.parametrize("pol,mode,k", [("rr", "intermittent", 2),
                                        ("edf-m", "persistent", 4),
                                        ("zygarde", "intermittent", 1)])
def test_simulate_stepped_matches_jax(pol, mode, k):
    """The scalar frontend (one device, no device axis) == JAX
    ``simulate_stepped`` on every ``SimResult`` field."""
    tasks = W.random_task_set(W.TASK_SET_SEEDS[k], k)
    harv, eta = W.MODES[mode]
    sim = SimConfig(policy=pol, horizon=SHORT, seed=3)
    ref = j_simulate_stepped(tasks, harv, eta, sim=sim, dt=W.DT)
    psim = PS.SimConfig(policy=pol, horizon=SHORT, seed=3)
    out = PS.simulate_stepped(port_tasks(tasks), port_harvester(harv), eta,
                              sim=psim, dt=W.DT, device="cpu")
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, f.name
    assert out.units_executed > 0
