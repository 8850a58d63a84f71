"""The port's fleet runs over a mesh against the reference's 4-device runs.

One JAX subprocess (``--xla_force_host_platform_device_count=4``, as
``tests/test_fleet.py``'s sharded test) runs the reference's sharded
``sweep``, ``run_segments`` (a hook that rewrites eta, and ``full``
telemetry) and ``TuneProblem(mesh=)`` objective on 6 devices over a 4-way
mesh, which pads the device axis to 8 by wrap-around, and saves them to an
npz.  The port runs the same calls on a 4-entry CPU mesh (the CPU device
listed four times): every result, carry and telemetry leaf equals the
reference's bit for bit, the hook sees the 8 padded devices and the
returned carry has the 6 real ones.  The objective equals the reference's
within the reference's own sharded-vs-unsharded ``rtol=1e-6`` and the
port's unsharded objective bit for bit (the port reduces the scores after
joining the blocks).
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import adapt as PA
from repro_torch import fleet as PF
from repro_torch.core import energy as PE
from repro_torch.core.scheduler import JobProfile, TaskSpec
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.telemetry import TelemetryConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _subproc import sub_env  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

HORIZON = 5.0

_TASK = """
n_units = 4
margins = np.linspace(0.05, 0.5, n_units)
passes = np.zeros(n_units, bool); passes[1:] = True
prof = JobProfile(margins, passes, np.ones(n_units, bool))
task = TaskSpec(task_id=0, period=1.0, deadline=2.0,
                unit_time=np.full(n_units, 0.1),
                unit_energy=np.full(n_units, 8e-3), profiles=[prof] * 15)
grid = fleet.SweepGrid(task=task, policies=("zygarde", "edf"),
                       etas=(0.4, 0.9, 1.0),
                       harvesters=(energy.Harvester("h", 0.9, 0.9, 0.06),),
                       horizon=%r)
x = {"eta": np.linspace(0.1, 1.0, 5, dtype=np.float32),
     "e_opt_fraction": np.linspace(0.1, 0.9, 5, dtype=np.float32)}


def etas(d, seg):
    return np.full(d, 0.5 + 0.1 * seg, np.float32)
""" % HORIZON

_REF = """
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
from repro import adapt, fleet
from repro.core import energy
from repro.core.scheduler import JobProfile, TaskSpec
from repro.launch.mesh import make_fleet_mesh
from repro.telemetry import TelemetryConfig
""" + _TASK + """
seen = []


def hook(seg, t_end, cfg, carry, telemetry=None):
    seen.append(np.asarray(cfg.eta).shape[0])
    return cfg._replace(eta=etas(seen[-1], seg))


mesh = make_fleet_mesh()
out = {}
res, _ = fleet.sweep(grid, mesh=mesh)
out.update({"sweep." + k: np.asarray(v) for k, v in res._asdict().items()})
cfg, statics, _ = fleet.build(grid)
res, carry, tel = fleet.run_segments(cfg, statics, 3, hook=hook, mesh=mesh,
                                     telemetry=TelemetryConfig(level="full"))
for name, tree in (("seg", res), ("carry", carry), ("tel", tel)):
    out.update({name + "." + k: np.asarray(v)
                for k, v in tree._asdict().items()})
out["seen"] = np.asarray(seen)
prob = adapt.TuneProblem(task=task, harvesters=grid.harvesters,
                         seeds=(0, 1), horizon=%r)
out["objective"] = np.asarray(
    dataclasses.replace(prob, mesh=mesh).objective()(x))
np.savez(sys.argv[1], **out)
print("MESH_REF_OK", mesh.size)
""" % HORIZON


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "ref.npz"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF), str(path)],
        capture_output=True, text=True, timeout=600, env=sub_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MESH_REF_OK 4" in out.stdout
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def port():
    """The task, grid and candidates of the reference's script, built by
    the port (its numpy code is the same)."""
    scope = dict(np=np, fleet=PF, energy=PE, JobProfile=JobProfile,
                 TaskSpec=TaskSpec)
    exec(textwrap.dedent(_TASK), scope)
    return scope


def mesh4():
    return make_fleet_mesh(4, device="cpu")


def assert_tree_equal(tree, ref, prefix):
    for f, a in zip(tree._fields, tree):
        b = ref[f"{prefix}.{f}"]
        assert a.shape[0] == 6, f"{prefix}.{f}"
        assert a.numpy().dtype == b.dtype, f"{prefix}.{f}"
        np.testing.assert_array_equal(a.numpy(), b,
                                      err_msg=f"{prefix}.{f}")


def test_sweep_over_a_mesh_matches_jax(ref, port):
    """``sweep(mesh=)`` in pallas mode (kernel A's plain version, once per
    block per step) on 6 devices over 4 equals the reference's 4-device
    sweep on every result leaf."""
    res, meta = PF.sweep(port["grid"], mesh=mesh4(), mode="pallas",
                         device="cpu")
    assert len(meta) == 6
    assert_tree_equal(res, ref, "sweep")


def test_run_segments_over_a_mesh_matches_jax(ref, port):
    """``run_segments(mesh=)`` with a hook and ``full`` telemetry: the hook
    sees the 8 padded devices, as the reference's does; the result, the
    carry and the telemetry come back with the 6 real devices, equal to
    the reference's on every leaf."""
    cfg, statics, _ = PF.build(port["grid"], "cpu")
    seen = []

    def hook(seg, t_end, cfg, carry, telemetry=None):
        seen.append(cfg.eta.shape[0])
        return cfg._replace(eta=torch.from_numpy(port["etas"](seen[-1],
                                                              seg)))

    res, carry, tel = PF.run_segments(
        cfg, statics, 3, hook=hook, mesh=mesh4(),
        telemetry=TelemetryConfig(level="full"))
    assert seen == [8, 8, 8] == ref["seen"].tolist()
    assert_tree_equal(res, ref, "seg")
    assert_tree_equal(carry, ref, "carry")
    assert_tree_equal(tel, ref, "tel")


def test_simulate_fleet_sharded_fused_and_resume(ref, port):
    """``simulate_fleet_sharded`` in fused mode (kernel B's plain version,
    once per block) equals the reference's sharded sweep; a carry resumed
    over the mesh from an unsharded first half ends where the whole run
    does; fused ``run_segments`` with a mesh is the reference's
    ValueError."""
    cfg, statics, _ = PF.build(port["grid"], "cpu")
    sharded = PF.simulate_fleet_sharded(cfg, statics, mesh=mesh4(),
                                        mode="fused")
    assert_tree_equal(sharded, ref, "sweep")
    half = statics.n_steps // 2
    _, c1 = PF.run_segments(cfg, dataclasses.replace(
        statics, horizon=half * statics.dt), 1)
    res, carry = PF.run_segments(cfg, statics, 2, carry=c1, start_step=half,
                                 mesh=mesh4())
    assert_tree_equal(res, ref, "sweep")
    assert all(x.shape[0] == 6 for x in carry)
    with pytest.raises(ValueError, match="mesh"):
        PF.run_segments(cfg, statics, 2, mesh=mesh4(), mode="fused")


def test_objective_over_a_mesh(ref, port):
    """``TuneProblem(mesh=)``: within ``rtol=1e-6`` of the reference's
    sharded objective (its own tolerance against its unsharded one) and
    bit for bit the port's unsharded objective."""
    prob = PA.TuneProblem(task=port["task"],
                          harvesters=port["grid"].harvesters, seeds=(0, 1),
                          horizon=HORIZON, device="cpu")
    sharded = dataclasses.replace(prob, mesh=mesh4()).objective()(port["x"])
    np.testing.assert_allclose(sharded, ref["objective"], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(sharded, prob.objective()(port["x"]))
