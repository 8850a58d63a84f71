"""The port's streaming serve (``FleetServeEngine.run_stream``) against its
monolithic ``run`` and against the JAX package.

Mirrors ``tests/test_stream_serve.py``: ``run_stream`` equals ``run`` bit
for bit for any chunking of the same job stream (windowed feature staging,
signed ``job0`` rebasing and the log shift must be invisible), with
adaptation on in both bank modes; per-device streams and ``total_jobs``
cycling stream as they run monolithically; the staged windows are
O(chunk); the fused stream (here the plain version of
``serve_fused_steps``) equals the scan stream.  ``_shift_log``, the window
width and the chunk count equal the JAX package's.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import energy as JE
from repro.serve import FleetServeEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve.fleet_engine import ServeLog as JServeLog
from repro.serve.fleet_engine import _shift_log as j_shift_log

from repro_torch.core import energy as PE
from repro_torch.fleet.state import ServeLog
from repro_torch.kernels import ops
from repro_torch.serve import FleetServeEngine, Request, ServeConfig
from repro_torch.serve.fleet_engine import _shift_log
from repro_torch.telemetry import TelemetryConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scalar_serve import (_jax_model, _port_model,  # noqa: E402
                                     _requests, build_models)
from _torch_threads import one_torch_thread  # noqa: E402,F401

_LOG_FIELDS = ("units", "pred", "correct", "margin", "exit_unit", "sched")


@pytest.fixture(scope="module")
def models():
    return build_models()


def _cfg(policy, n, adapt, period=2.0, deadline=1.5, cls=ServeConfig):
    return cls(policy=policy, period=period, deadline=deadline,
               horizon=n * period + 2.0, adapt=adapt, start_charged=True,
               sim_dt=0.05)


def _engine(models, cfg, threshold=None, **kw):
    return FleetServeEngine([_port_model(models, 0, threshold)],
                            PE.Harvester("battery", 1.0, 0.0, 1.0), eta=1.0,
                            config=cfg, feature_batch=1, device="cpu", **kw)


def _reqs(n, period=2.0):
    return _requests(Request, n, period, 1)[0]


def _assert_same_outcome(ra, rb, jobs):
    """Bit equality of the per-job logs, the end carry and the job count."""
    for f in _LOG_FIELDS:
        a, b = getattr(ra, f), getattr(rb, f)
        np.testing.assert_array_equal(a[..., :jobs], b[..., :jobs],
                                      err_msg=f)
    for part in ("dev", "bank"):
        pa, pb = getattr(ra.carry, part), getattr(rb.carry, part)
        for f, a, b in zip(pa._fields, pa, pb):
            assert torch.equal(a, b), f"{part}.{f}"
    for f, a, b in zip(ra.fleet._fields, ra.fleet, rb.fleet):
        assert torch.equal(a, b), f"fleet.{f}"
    assert ra.jobs == rb.jobs


_MONO: dict = {}


def _mono(models, bank_mode):
    """The monolithic adaptive run both chunkings are held to (once per
    bank mode)."""
    if bank_mode not in _MONO:
        cfg = _cfg("zygarde", 4, adapt=True)
        _MONO[bank_mode] = _engine(models, cfg, 0.02,
                                   bank_mode=bank_mode).run(
            [_reqs(4)], n_devices=2)
    return _MONO[bank_mode]


@pytest.mark.parametrize("bank_mode", ["per-device", "shared"])
@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_stream_matches_monolithic(models, bank_mode, n_chunks):
    """run_stream == run, bit for bit, for any chunking, with adaptation on
    (the bank evolves across chunk boundaries) in both bank modes."""
    r_mono = _mono(models, bank_mode)
    cfg = _cfg("zygarde", 4, adapt=True)
    eng = _engine(models, cfg, 0.02, bank_mode=bank_mode)
    r_st = eng.run_stream([_reqs(4)], n_devices=2, n_chunks=n_chunks)
    assert r_st.n_chunks == n_chunks
    assert r_st.compile_s == 0.0 and r_st.peak_bytes == 0
    _assert_same_outcome(r_mono, r_st, jobs=4)
    # adaptation really happened: the banks gained mass
    copies = 2 if bank_mode == "per-device" else 1
    assert float(r_st.carry.bank.counts.sum()) > copies * float(
        eng.bank0.counts.sum())


def test_stream_per_device_streams(models):
    """Per-device request streams (batched feature tables) stream the same
    way they run monolithically."""
    n = 5
    cfg = _cfg("zygarde", n, adapt=False)
    base = _reqs(n)
    streams = [[base], [[Request(r.x, r.label, release=k * cfg.period)
                         for k, r in enumerate(base[::-1])]]]
    r_mono = _engine(models, cfg).run(streams)
    r_st = _engine(models, cfg).run_stream(streams, n_chunks=2)
    _assert_same_outcome(r_mono, r_st, jobs=n)


def test_stream_total_jobs_cycles_base(models):
    """total_jobs beyond the base stream cycles it: identical to a
    monolithic run over the explicitly repeated request list."""
    base_n, total = 3, 7
    cfg = _cfg("zygarde", total, adapt=False)
    base = _reqs(base_n)
    repeated = [Request(base[i % base_n].x, base[i % base_n].label,
                        release=i * cfg.period) for i in range(total)]
    r_mono = _engine(models, cfg).run([repeated], n_devices=2)
    r_st = _engine(models, cfg).run_stream([base], n_devices=2,
                                           total_jobs=total, n_chunks=3)
    assert r_st.jobs == r_mono.jobs == 2 * total
    _assert_same_outcome(r_mono, r_st, jobs=total)


def test_stream_bounds_the_window(models):
    """The staged window tables are O(chunk): finer chunking shrinks the
    resident window, and both stay below the monolithic job axis; the
    8-chunk and 2-chunk streams (fused: the plain version here) agree."""
    n = 16
    cfg = _cfg("zygarde", n, adapt=False)
    reqs = _reqs(n)
    r8 = _engine(models, cfg).run_stream([reqs], n_devices=2, n_chunks=8,
                                         mode="fused")
    r2 = _engine(models, cfg).run_stream([reqs], n_devices=2, n_chunks=2,
                                         mode="fused")
    _assert_same_outcome(r2, r8, jobs=n)
    w8 = r8.carry.log.units.shape[-1]
    w2 = r2.carry.log.units.shape[-1]
    assert w8 <= w2 < n
    assert w8 < w2
    assert 0 < r8.chunk_table_bytes < r2.chunk_table_bytes


def test_fused_stream_matches_scan_stream(models):
    """Streaming chunks through the fused kernel's plain version ==
    streaming them through the scan == the monolithic run."""
    n = 5
    cfg = _cfg("zygarde", n, adapt=False)
    reqs = _reqs(n)
    r_mono = _engine(models, cfg, 0.02).run([reqs], n_devices=2)
    before = ops.launch_counts()
    r_fused = _engine(models, cfg, 0.02).run_stream(
        [reqs], n_devices=2, n_chunks=2, mode="fused")
    r_scan = _engine(models, cfg, 0.02).run_stream(
        [reqs], n_devices=2, n_chunks=2)
    assert ops.launch_counts() == before     # the CPU launches nothing
    _assert_same_outcome(r_mono, r_fused, jobs=n)
    _assert_same_outcome(r_scan, r_fused, jobs=n)
    assert (r_fused.exit_unit >= 0).any()


def test_stream_rejects_adapt_and_unported_options(models):
    n = 2
    reqs = _reqs(n)
    with pytest.raises(ValueError, match="adapt"):
        _engine(models, _cfg("zygarde", n, adapt=True)).run_stream(
            [reqs], n_devices=1, mode="fused")
    eng = _engine(models, _cfg("zygarde", n, adapt=False))
    out = eng.run_stream([reqs], n_devices=1, telemetry=TelemetryConfig())
    assert int(out.telemetry.c_release[0]) == out.jobs == n
    with pytest.raises(ValueError, match="counters"):
        eng.run_stream([reqs], n_devices=1,
                       telemetry=TelemetryConfig(level="full"))
    with pytest.raises(ValueError):
        eng.run_stream([reqs], n_devices=1, mode="bogus")


@pytest.mark.parametrize("seed", range(4))
def test_shift_log_matches_jax(seed):
    """_shift_log == JAX's on random logs and shifts (zero, inside and past
    the window), every leaf bit for bit."""
    rng = np.random.default_rng(seed)
    D, K, W = 3, 4, 7
    log = dict(units=rng.integers(0, 5, (D, K, W)).astype(np.int32),
               pred=rng.integers(-1, 3, (D, K, W)).astype(np.int32),
               correct=rng.random((D, K, W)) < 0.5,
               margin=rng.normal(size=(D, K, W)).astype(np.float32),
               exit_unit=rng.integers(-1, 4, (D, K, W)).astype(np.int32),
               sched=rng.random((D, K, W)) < 0.5)
    shift = np.array([0, rng.integers(1, W), W, W + 3], np.int32)
    ref = j_shift_log(JServeLog(**{k: jnp.asarray(v) for k, v in
                                   log.items()}), jnp.asarray(shift))
    out = _shift_log(ServeLog(**{k: torch.from_numpy(v) for k, v in
                                 log.items()}), torch.from_numpy(shift))
    for f, a, b in zip(ServeLog._fields, out, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy().view(np.uint8),
                                      b.view(np.uint8), err_msg=f)


@pytest.mark.parametrize("n_chunks", [3])
def test_window_and_chunks_match_jax(models, n_chunks):
    """The window width and chunk count equal JAX's run_stream on the same
    config; so do the discrete outcomes (each package its own CNN)."""
    n, total = 4, 10
    jcfg = _cfg("zygarde", total, False, cls=JServeConfig)
    jeng = JEngine([_jax_model(models, 0)],
                   JE.Harvester("battery", 1.0, 0.0, 1.0), eta=1.0,
                   config=jcfg, feature_batch=1)
    ref = jeng.run_stream([_requests(JRequest, n, 2.0, 1)[0]], n_devices=2,
                          total_jobs=total, n_chunks=n_chunks)
    out = _engine(models, _cfg("zygarde", total, False)).run_stream(
        [_reqs(n)], n_devices=2, total_jobs=total, n_chunks=n_chunks)
    assert out.n_chunks == ref.n_chunks == n_chunks
    assert out.carry.log.units.shape == tuple(ref.carry.log.units.shape)
    assert out.chunk_table_bytes == ref.chunk_table_bytes
    assert out.jobs == ref.jobs
    for f in ("units", "pred", "correct", "exit_unit", "sched"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.margin, ref.margin, rtol=0, atol=1e-5)
    jax.block_until_ready(ref.fleet)
