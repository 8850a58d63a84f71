"""Live fleet serving over a mesh against the reference's 4-device runs.

One JAX subprocess (``--xla_force_host_platform_device_count=4``) builds
``tests/test_torch_serve.py``'s two agile CNNs and their banks, serves 8
devices with ``FleetServeEngine.run`` on ``make_fleet_mesh()`` (4 devices)
and saves each run's build, its carry, fleet result and telemetry, and the
same run without a mesh.  The port runs ``FleetServeEngine.run`` on
``make_fleet_mesh(4, device="cpu")`` (the CPU device listed four times)
from the reference's converted build, so both serve the same features:

* a per-device bank with adaptation, a shared bank with adaptation, the
  shared bank with ``full`` telemetry, and a per-device bank in two
  segments;
* every fleet result and telemetry leaf is equal bit for bit, and so is
  every carry leaf except the centroid rows that propagation refreshes
  through a unit's convolution and the margins classified against them,
  which hold at ``CNN_TOL`` (the port's convolutions are PyTorch's, not
  XLA's: ``tests/test_torch_serve.py`` holds the run without a mesh the
  same way);
* the shared bank's unit-0 rows, which the reference's 4-device run sums
  in its own order (each device's rows, then the devices' partial sums in
  device order) and which therefore differ from its run without a mesh,
  equal the 4-device run's bit for bit.

The reference's ``ValueError``\\ s for a ``D`` that does not divide over
the mesh and for ``mode="fused"`` with a mesh hold too.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.serve import Request
from repro_torch.telemetry import TelemetryConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _subproc import sub_env  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_serve import (  # noqa: E402,F401
    _assert_carry,
    _port_engine,
    _requests,
    _streams,
    models,
)

N_DEV = 8
#: (name, bank mode, adapt, telemetry level, segments)
CASES = (("per-device", "per-device", True, None, 1),
         ("shared", "shared", True, None, 1),
         ("shared-full", "shared", True, "full", 1),
         ("segments", "per-device", False, None, 2))

_REF = """
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax
import jax.numpy as jnp
import numpy as np
import test_torch_serve as TS
from repro.core import energy as JE
from repro.core import kmeans as JK
from repro.core.agile import AgileCNN
from repro.launch.mesh import make_fleet_mesh
from repro.models import cnn as JC
from repro.serve import FleetServeEngine, Request, ServeConfig
from repro.telemetry import TelemetryConfig

xtr, ytr = TS._data(1, 96)
jms = []
for i, spec in enumerate(TS.SPECS):
    cfg = JC.CNNConfig(*spec)
    params = JC.init_cnn_params(cfg, jax.random.PRNGKey(i))
    feats = [np.asarray(f) for f in
             JC.cnn_forward_all(cfg, params, jnp.asarray(xtr))]
    jms.append((cfg, params, JK.fit_bank(
        feats, ytr, thresholds=[0.02] * len(feats), seed=i)))
reqs = TS._requests(Request, TS._streams(False), False)
mesh = make_fleet_mesh()
out = {}


def put(prefix, tree):
    for f, v in zip(tree._fields, tree):
        if hasattr(v, "_fields"):
            put(prefix + "." + f, v)
        else:
            out[prefix + "." + f] = np.asarray(v)


for name, bank_mode, adapt, level, n_seg in %r:
    eng = FleetServeEngine(
        [AgileCNN(c, p, list(b)) for c, p, b in jms],
        JE.Harvester("battery", 1.0, 0.0, 1.0), eta=1.0,
        config=ServeConfig(**TS._config_kw("zygarde", adapt)),
        bank_mode=bank_mode)
    cfg, _, tables, carry0, _ = eng.build(reqs, n_devices=%d)
    put(name + ".build.cfg", cfg)
    put(name + ".build.tables", tables)
    put(name + ".build.carry", carry0)
    tel = None if level is None else TelemetryConfig(level=level)
    res = eng.run(reqs, n_devices=%d, mesh=mesh, n_segments=n_seg,
                  telemetry=tel)
    put(name + ".carry", res.carry)
    put(name + ".fleet", res.fleet)
    if res.telemetry is not None:
        put(name + ".tel", res.telemetry)
    put(name + ".plain", eng.run(reqs, n_devices=%d).carry)
np.savez(sys.argv[1], **out)
print("SERVE_MESH_REF_OK", mesh.size)
""" % (CASES, N_DEV, N_DEV, N_DEV)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_mesh") / "ref.npz"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF), str(path),
         str(Path(__file__).resolve().parent)],
        capture_output=True, text=True, timeout=600, env=sub_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SERVE_MESH_REF_OK 4" in out.stdout
    with np.load(path) as z:
        return dict(z)


def _tree(ref, prefix):
    """The saved leaves under ``prefix`` as nested dicts."""
    out = {}
    for key, v in ref.items():
        if key.startswith(prefix + "."):
            *path, leaf = key[len(prefix) + 1:].split(".")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
    return out


def _mesh_run(models, ref, name, bank_mode, adapt, level, n_seg):
    """The port's run over the 4-entry CPU mesh from the reference's
    build (the port's own statics)."""
    eng = _port_engine(models, "zygarde", adapt, bank_mode)
    reqs = _requests(Request, _streams(False), False)
    _, statics, _, _, per_dev = eng.build(reqs, N_DEV)
    b = _tree(ref, name + ".build")
    built = (convert.step_params(b["cfg"], "cpu"), statics,
             convert.serve_tables(b["tables"], "cpu"),
             convert.serve_carry(b["carry"], "cpu"), per_dev)
    eng.build = lambda *a, **k: built
    tel = None if level is None else TelemetryConfig(level=level)
    return eng.run(reqs, N_DEV, mesh=make_fleet_mesh(4, device="cpu"),
                   n_segments=n_seg, telemetry=tel)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_serve_run_over_a_mesh_matches_jax(models, ref, case):
    name, _, adapt = case[:3]
    res = _mesh_run(models, ref, *case)
    want = convert.serve_carry(_tree(ref, name + ".carry"), "cpu")
    if adapt:
        _assert_carry(res.carry, want,
                      tol_fields=("dev.q_margin", "log.margin"),
                      tol_bank_from_unit=1)
    else:
        _assert_carry(res.carry, want)
    fleet = _tree(ref, name + ".fleet")
    for f, a in zip(res.fleet._fields, res.fleet):
        np.testing.assert_array_equal(a.numpy(), fleet[f], err_msg=f)
    for f in ("units", "pred", "correct", "exit_unit", "sched"):
        np.testing.assert_array_equal(getattr(res, f),
                                      getattr(want.log, f).numpy(),
                                      err_msg=f)
    if case[3] is not None:
        tel = _tree(ref, name + ".tel")
        for f, a in zip(res.telemetry._fields, res.telemetry):
            np.testing.assert_array_equal(a.numpy(), tel[f], err_msg=f)


def test_shared_bank_follows_the_partitioned_sum(models, ref):
    """The witness: the reference's 4-device shared-bank run moves unit-0
    centroid entries (no convolution in their path) away from its run
    without a mesh; the port's mesh run equals the 4-device run there."""
    res = _mesh_run(models, ref, *CASES[1])
    mesh_c = ref["shared.carry.bank.centroids"][:, 0]
    plain_c = ref["shared.plain.bank.centroids"][:, 0]
    witness = mesh_c != plain_c
    assert witness.sum() > 0
    got = res.carry.bank.centroids[:, 0].numpy()
    np.testing.assert_array_equal(got[witness], mesh_c[witness])


def test_mesh_errors_are_the_references(models):
    """``D`` that does not divide over the mesh, and ``mode="fused"`` with
    a mesh, are ValueErrors as in the reference."""
    eng = _port_engine(models, "zygarde", False, "per-device")
    reqs = _requests(Request, _streams(False), False)
    mesh = make_fleet_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="mesh size 4"):
        eng.run(reqs, 6, mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        eng.run(reqs, 8, mesh=mesh, mode="fused")
