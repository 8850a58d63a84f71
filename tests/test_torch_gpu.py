"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs.  Every test needs a CUDA card and skips
without one; the file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import energy
from repro_torch.core import kmeans as km
from repro_torch.core.agile import AgileCNN
from repro_torch.kernels import centroid_update as CU
from repro_torch.kernels import fleet_step
from repro_torch.kernels import l1_topk2 as L1
from repro_torch.kernels import ops
from repro_torch.models import cnn
from repro_torch.serve import FleetServeEngine, Request, ServeConfig

pytestmark = pytest.mark.gpu

L1_CASES = [(1, 1, 1), (7, 33, 3), (50, 150, 5), (13, 257, 4), (9, 1025, 2),
            (5, 8193, 5), (64, 31, 8), (250, 150, 5)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("per_row", [False, True])
def test_l1_topk2_kernel_matches_plain(cuda, per_row):
    rng = np.random.default_rng(0)
    for B, d, k in L1_CASES:
        x = rng.normal(size=(B, d)).astype(np.float32)
        c = rng.normal(size=(B, k, d) if per_row else (k, d)).astype(
            np.float32)
        xg, cg = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
        n0 = L1.launches
        out = L1.l1_topk2(xg, cg)
        torch.cuda.synchronize()
        assert L1.launches == n0 + 1
        for a, b in zip(out, L1.l1_topk2_plain(xg, cg)):
            assert torch.equal(a, b), (B, d, k)


def test_centroid_update_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    for B, d, k in [(64, 8192, 5), (7, 33, 3), (300, 100, 4)]:
        c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
        a = torch.from_numpy(rng.integers(-1, k, B).astype(np.int32))
        c, x, a = c.to(cuda), x.to(cuda), a.to(cuda)
        out = CU.centroid_update(c, x, a, 32.0)
        torch.cuda.synchronize()
        assert torch.equal(out, CU.centroid_update_plain(c, x, a, 32.0))


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError):
        L1.l1_topk2(x.t(), torch.zeros(3, 8, device=cuda))   # strided
    with pytest.raises(ValueError):
        L1.l1_topk2(x, torch.zeros(3, 16))                   # mixed devices
    with pytest.raises(ValueError):
        CU.centroid_update(torch.zeros(16, 3, device=cuda).t(), x,
                           torch.zeros(8, dtype=torch.int32, device=cuda),
                           32.0)


def _engine(device, adapt, bank_mode):
    """Two narrow agile CNNs on 32x32x3 inputs with fitted banks."""
    rng = np.random.default_rng(2)
    protos = np.kron(rng.normal(size=(3, 8, 8, 3)), np.ones((1, 4, 4, 1)))
    y = rng.integers(0, 3, 72).astype(np.int32)
    x = (1.5 * protos[y] + rng.normal(size=(72, 32, 32, 3))).astype(
        np.float32)
    models = []
    for seed, spec in enumerate((
            ("a", (32, 32, 3), ((4, 5, True), (8, 5, True)), (16,), 3),
            ("b", (32, 32, 3), ((6, 5, True),), (12, 8), 3))):
        cfg = cnn.CNNConfig(*spec)
        params = cnn.init_cnn_params(cfg, torch.Generator().manual_seed(seed),
                                     device=device)
        feats = cnn.cnn_forward_all(cfg, params,
                                    torch.from_numpy(x[:64]).to(device))
        bank = km.fit_bank([f.cpu().numpy() for f in feats], y[:64],
                           thresholds=[0.02] * cfg.n_units, device=device)
        models.append(AgileCNN(cfg, params, bank))
    reqs = [[Request(x[64 + j], int(y[64 + j]), release=2.0 * j)
             for j in range(4)] for _ in models]
    conf = ServeConfig(policy="zygarde", period=2.0, deadline=1.8,
                       horizon=10.0, adapt=adapt, unit_time=np.full(3, 0.3),
                       start_charged=True)
    eng = FleetServeEngine(models, energy.calibrate_harvester(0.71, 0.35),
                           eta=0.71, config=conf, bank_mode=bank_mode,
                           device=device)
    return eng, reqs


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_fused_kernel_matches_scan(cuda, bank_mode):
    """Kernel C, one launch per segment, == the scan (classify through
    kernel D) on every carry leaf."""
    eng, reqs = _engine(cuda, False, bank_mode)
    ops.reset_launch_counts()
    scan = eng.run(reqs, 5, seeds=range(5), n_segments=3)
    assert ops.launch_counts()["l1_topk2"] > 0
    fused = eng.run(reqs, 5, seeds=range(5), n_segments=3, mode="fused")
    assert ops.launch_counts()["serve_fused_steps"] == 3
    for part in ("dev", "bank", "log"):
        a_p, b_p = getattr(scan.carry, part), getattr(fused.carry, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            assert torch.equal(a, b), f"{part}.{f}"
    assert fleet_step.launches >= 3


def test_scan_on_card_matches_cpu(cuda):
    """The serve loop on the card (kernel D) == the CPU's plain loop from
    the same built state, bit for bit."""
    eng, reqs = _engine(cuda, False, "per-device")
    cfg, statics, tables, carry0, _ = eng.build(reqs, 4, seeds=range(4))
    kw = dict(statics=statics, n_steps=statics.n_steps, adapt=False)
    on_card = eng._scan_steps(cfg, tables, carry0, 0, **kw)

    def cpu(tree):
        return type(tree)(*[cpu(v) if isinstance(v, tuple) else v.cpu()
                            for v in tree])

    on_cpu = eng._scan_steps(cpu(cfg), cpu(tables), cpu(carry0), 0, **kw)
    for part in ("dev", "bank", "log"):
        a_p, b_p = getattr(on_card, part), getattr(on_cpu, part)
        for f, a, b in zip(a_p._fields, a_p, b_p):
            assert torch.equal(a.cpu(), b), f"{part}.{f}"


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
def test_adaptive_serving_runs_through_the_kernels(cuda, bank_mode):
    eng, reqs = _engine(cuda, True, bank_mode)
    ops.reset_launch_counts()
    res = eng.run(reqs, 4, seeds=range(4))
    counts = ops.launch_counts()
    assert counts["l1_topk2"] > 0
    if bank_mode == "shared":
        assert counts["centroid_update"] > 0
    assert (res.exit_unit >= 0).any()
    assert np.isfinite(res.margin).all()
