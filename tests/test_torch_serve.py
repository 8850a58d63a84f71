"""Live fleet serving in the PyTorch port against the JAX package.

Two small agile CNNs (different depths, so the stacked bank is padded) are
built with the JAX package from a seed and fitted with its k-means bank;
``repro_torch.convert`` carries the weights, banks and the engine's built
``(cfg, tables, carry0)`` across, so both packages serve the same requests
from the same state.

* ``adapt=False``: every leaf of the port's serve loop equals the JAX
  engine's, for every policy, both bank modes, per-device request streams
  and any segmentation.
* ``adapt=True``: adapted unit-0 centroid rows, counts and every integer
  and boolean leaf are exact; rows refreshed by propagation pass through a
  convolution and get the CNN tolerance, and so do the margins classified
  against them.
* ``mode="fused"`` (here the plain version of ``serve_fused_steps``)
  equals ``mode="scan"`` leaf for leaf.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import energy as JE
from repro.core import kmeans as JK
from repro.core.agile import AgileCNN as JAgileCNN
from repro.models import cnn as JC
from repro.serve import FleetServeEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig

from repro_torch import convert
from repro_torch.core import energy as PE
from repro_torch.core.agile import AgileCNN
from repro_torch.core.step import StepStatics
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.models import cnn as PC
from repro_torch.serve import FleetServeEngine, Request, ServeConfig
from repro_torch.telemetry import TelemetryConfig
from _torch_threads import one_torch_thread  # noqa: F401

SPECS = (("tiny3", (16, 16, 1), ((4, 5, True), (8, 5, True)), (16,), 3),
         ("tiny2", (16, 16, 1), ((6, 5, True),), (12,), 3))
N_JOBS = 4
PERIOD = 2.0
CNN_TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed, n):
    """Class-structured images: smooth class prototypes plus noise."""
    protos = np.random.default_rng(100).normal(size=(3, 4, 4, 1))
    protos = np.kron(protos, np.ones((1, 4, 4, 1)))
    r = np.random.default_rng(seed)
    y = r.integers(0, 3, n)
    x = 1.5 * protos[y] + r.normal(size=(n, 16, 16, 1))
    return x.astype(np.float32), y.astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """JAX models + fitted banks and their converted port twins (CPU)."""
    xtr, ytr = _data(1, 96)
    jms, pms = [], []
    for i, spec in enumerate(SPECS):
        jcfg = JC.CNNConfig(*spec)
        params = JC.init_cnn_params(jcfg, jax.random.PRNGKey(i))
        feats = [np.asarray(f) for f in
                 JC.cnn_forward_all(jcfg, params, jnp.asarray(xtr))]
        bank = JK.fit_bank(feats, ytr, thresholds=[0.02] * len(feats),
                           seed=i)
        jms.append((jcfg, params, bank))
        pms.append((PC.CNNConfig(*spec),
                    convert.cnn_params(jax.tree.map(np.asarray, params),
                                       "cpu"),
                    convert.bank([jax.tree.map(np.asarray, uc)
                                  for uc in bank], "cpu")))
    return jms, pms


def _streams(per_device):
    xte, yte = _data(2, 2 * N_JOBS)
    base = [[(xte[k * N_JOBS + j], int(yte[k * N_JOBS + j]))
             for j in range(N_JOBS)] for k in range(len(SPECS))]
    if not per_device:
        return base
    # per-device streams: device d serves its tasks' requests rotated by d
    return [[[s[(j + d) % N_JOBS] for j in range(N_JOBS)] for s in base]
            for d in range(3)]


def _requests(cls, streams, per_device):
    def one(stream):
        return [[cls(x, y, release=j * PERIOD) for j, (x, y) in
                 enumerate(task)] for task in stream]

    return [one(s) for s in streams] if per_device else one(streams)


def _config_kw(policy, adapt):
    return dict(policy=policy, period=PERIOD, deadline=1.8,
                horizon=N_JOBS * PERIOD + 2.0, adapt=adapt,
                unit_time=np.full(3, 0.3), start_charged=True)


# compiled JAX serve loops, shared by engines over the same models and bank
# mode (the policy is a config value, not part of the compiled program)
_JAX_RUNNERS: dict = {}


def _jax_engine(models, policy, adapt, bank_mode):
    jms, _ = models
    eng = JEngine([JAgileCNN(c, p, [uc for uc in b]) for c, p, b in jms],
                  JE.Harvester("battery", 1.0, 0.0, 1.0), eta=1.0,
                  config=JServeConfig(**_config_kw(policy, adapt)),
                  bank_mode=bank_mode)
    eng._runners = _JAX_RUNNERS.setdefault((id(jms), bank_mode, adapt), {})
    return eng


def _port_engine(models, policy, adapt, bank_mode, device="cpu"):
    _, pms = models
    ms = [AgileCNN(c, {g: [{k: v.to(device) for k, v in layer.items()}
                           for layer in p[g]] for g in p},
                   [type(uc)(*[t.to(device) for t in uc]) for uc in b])
          for c, p, b in pms]
    return FleetServeEngine(ms, PE.Harvester("battery", 1.0, 0.0, 1.0),
                            eta=1.0,
                            config=ServeConfig(**_config_kw(policy, adapt)),
                            bank_mode=bank_mode, device=device)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_scan(models, jeng, policy, adapt, bank_mode, requests,
               n_segments):
    """Convert JAX's built state and run the port's serve loop on it."""
    cfg, statics, tables, carry0, _ = jeng.build(requests, n_devices=3)
    peng = _port_engine(models, policy, adapt, bank_mode)
    pst = StepStatics(statics.queue_size, statics.dt, statics.horizon,
                      statics.slot_s)
    out = convert.serve_carry(_np(carry0), "cpu")
    pcfg = convert.step_params(_np(cfg), "cpu")
    ptab = convert.serve_tables(_np(tables), "cpu")
    i0 = 0
    for n in (len(c) for c in np.array_split(np.arange(pst.n_steps),
                                             n_segments)):
        out = peng._scan_steps(pcfg, ptab, out, i0, statics=pst, n_steps=n,
                               adapt=adapt)
        i0 += n
    return out


def _leaves(carry):
    for grp in ("dev", "bank", "log"):
        part = getattr(carry, grp)
        for f, v in zip(part._fields, part):
            yield f"{grp}.{f}", v


def _assert_carry(port, ref, tol_fields=(), tol_bank_from_unit=None):
    for (name, a), (_, b) in zip(_leaves(port), _leaves(_np(ref))):
        a = a.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in tol_fields:
            np.testing.assert_allclose(a, b, **CNN_TOL, err_msg=name)
        elif name == "bank.centroids" and tol_bank_from_unit is not None:
            u0 = tol_bank_from_unit
            np.testing.assert_array_equal(a[..., :u0, :, :],
                                          b[..., :u0, :, :], err_msg=name)
            np.testing.assert_allclose(a[..., u0:, :, :], b[..., u0:, :, :],
                                       **CNN_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                          np.atleast_1d(b).view(np.uint8),
                                          err_msg=name)


def test_classify_unit_matches_jax(models):
    """Single-row live classification on the shared bank: margin, cluster
    and prediction bit-equal for every (task, unit, job)."""
    from repro.serve.fleet_engine import classify_unit as jclassify_unit
    from repro_torch.fleet.state import ServeBank
    from repro_torch.serve.fleet_engine import classify_unit

    jeng = _jax_engine(models, "zygarde", False, "shared")
    _, _, tables, carry0, _ = jeng.build(
        _requests(JRequest, _streams(False), False), n_devices=1)
    ptab = convert.serve_tables(_np(tables), "cpu")
    pbank = convert.named_tuple(ServeBank, _np(carry0.bank), "cpu")
    for tk, spec in enumerate(SPECS):
        for u in range(len(spec[2]) + len(spec[3])):
            for job in range(N_JOBS):
                ref = jclassify_unit(carry0.bank, tables, tk, u, job)
                out = classify_unit(pbank, ptab, tk, u, job)
                for name, a, b in zip(("margin", "ci", "pred"), out, ref):
                    b = np.asarray(b)
                    assert a.numpy().dtype == b.dtype, name
                    np.testing.assert_array_equal(
                        np.atleast_1d(a.numpy()).view(np.uint8),
                        np.atleast_1d(b).view(np.uint8),
                        err_msg=f"{name} at task {tk} unit {u} job {job}")


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
@pytest.mark.parametrize("policy", ["zygarde", "edf", "edf-m", "rr"])
def test_scan_matches_jax(models, policy, bank_mode):
    """adapt=False, 3 devices: the port's serve loop from JAX's converted
    build equals JAX's run leaf for leaf, in one segment and in two."""
    jeng = _jax_engine(models, policy, False, bank_mode)
    reqs = _requests(JRequest, _streams(False), False)
    ref = jeng.run(reqs, n_devices=3).carry
    for n_segments in (1, 2):
        out = _port_scan(models, jeng, policy, False, bank_mode, reqs,
                         n_segments)
        _assert_carry(out, ref)
    log = _np(ref.log)
    assert (log.exit_unit >= 0).any() and (log.units > 0).all()


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_scan_with_adaptation_matches_jax(models, bank_mode):
    """adapt=True: exact where no convolution intervenes, the CNN tolerance
    on propagated centroid rows and the margins classified against them."""
    jeng = _jax_engine(models, "zygarde", True, bank_mode)
    reqs = _requests(JRequest, _streams(False), False)
    ref = jeng.run(reqs, n_devices=3).carry
    out = _port_scan(models, jeng, "zygarde", True, bank_mode, reqs, 2)
    _assert_carry(out, ref, tol_fields=("dev.q_margin", "log.margin"),
                  tol_bank_from_unit=1)
    # adaptation really happened: counts grew
    assert float(np.asarray(ref.bank.counts).sum()) > float(
        np.asarray(jeng.bank0.counts).sum()) * (
            3 if bank_mode == "per-device" else 1)


def test_per_device_streams_match_jax(models):
    jeng = _jax_engine(models, "zygarde", False, "per-device")
    reqs = _requests(JRequest, _streams(True), True)
    ref = jeng.run(reqs).carry
    out = _port_scan(models, jeng, "zygarde", False, "per-device", reqs, 1)
    _assert_carry(out, ref)


@pytest.mark.parametrize("bank_mode,per_device",
                         [("per-device", False), ("shared", True)])
def test_fused_matches_scan(models, bank_mode, per_device):
    """run(mode="fused") — on the CPU the plain version of
    serve_fused_steps — equals run(mode="scan") leaf for leaf."""
    eng = _port_engine(models, "zygarde", False, bank_mode)
    reqs = _requests(Request, _streams(per_device), per_device)
    n_dev = None if per_device else 3
    before = ops.launch_counts()
    scan = eng.run(reqs, n_dev, n_segments=2)
    fused = eng.run(reqs, n_dev, n_segments=2, mode="fused")
    assert ops.launch_counts() == before     # the CPU launches nothing
    for (name, a), (_, b) in zip(_leaves(scan.carry), _leaves(fused.carry)):
        assert torch.equal(a, b), name
    for f in ("units", "pred", "correct", "margin", "exit_unit", "sched"):
        np.testing.assert_array_equal(getattr(scan, f), getattr(fused, f))


def test_fused_rejects_adapt_and_unported_options(models):
    """The fused mode's ValueErrors (adaptation, telemetry, a mesh); a run
    over a one-device mesh equals the run without one (a per-device bank
    without adaptation, a shared bank with it); ``D`` that does not divide
    over the mesh is the reference's ValueError, and a run over a mesh of
    two devices (two blocks, per-device banks) equals the run without one
    (``tests/test_torch_serve_mesh.py`` holds larger meshes to the
    reference's multi-device runs)."""
    reqs = _requests(Request, _streams(False), False)
    with pytest.raises(ValueError, match="adapt"):
        _port_engine(models, "zygarde", True, "per-device").run(
            reqs, 1, mode="fused")
    eng = _port_engine(models, "zygarde", False, "per-device")
    with pytest.raises(ValueError):
        eng.run(reqs, 1, mode="bogus")
    out = eng.run(reqs, 1, telemetry=TelemetryConfig())
    assert out.telemetry is not None and int(out.telemetry.c_release[0]) \
        == out.jobs
    with pytest.raises(ValueError, match="telemetry"):
        eng.run(reqs, 1, telemetry=TelemetryConfig(), mode="fused")
    one = make_fleet_mesh(device="cpu")
    for e in (eng, _port_engine(models, "zygarde", True, "shared")):
        plain, on_mesh = e.run(reqs, 2), e.run(reqs, 2, mesh=one)
        for (name, a), (_, b) in zip(_leaves(plain.carry),
                                     _leaves(on_mesh.carry)):
            assert torch.equal(a, b), name
    two = make_fleet_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh size 2"):
        eng.run(reqs, 3, mesh=two)
    with pytest.raises(ValueError, match="mesh"):
        eng.run(reqs, 2, mesh=two, mode="fused")
    plain, on_two = eng.run(reqs, 2), eng.run(reqs, 2, mesh=two)
    for (name, a), (_, b) in zip(_leaves(plain.carry), _leaves(on_two.carry)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_whole_slice_matches_jax(models, bank_mode):
    """The port's own FleetServeEngine.run (its own CNN features, its own
    build) vs JAX's run on the same requests, adaptation on: every discrete
    outcome and fleet counter equal, margins within the CNN tolerance."""
    jres = _jax_engine(models, "zygarde", True, bank_mode).run(
        _requests(JRequest, _streams(False), False), n_devices=3)
    pres = _port_engine(models, "zygarde", True, bank_mode).run(
        _requests(Request, _streams(False), False), n_devices=3)
    for f in ("units", "pred", "correct", "exit_unit", "sched"):
        np.testing.assert_array_equal(getattr(pres, f), getattr(jres, f),
                                      err_msg=f)
    np.testing.assert_allclose(pres.margin, jres.margin, rtol=0, atol=1e-5)
    for f, a, b in zip(pres.fleet._fields, pres.fleet, jres.fleet):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert pres.jobs == jres.jobs == 3 * len(SPECS) * N_JOBS
