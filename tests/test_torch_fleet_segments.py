"""The port's segmented replay runner against the JAX package.

``run_segments`` splits the horizon into chunks, hands the full carry to a
host hook at each boundary and resumes from a carry.  With no hook the
chunked run equals the monolithic one for any segment count; resumed and
hooked runs equal the JAX package's on every result and carry leaf; the
checkpoint layout (``pack_carry``) round-trips and matches the
reference's.  The grid builders (``build``, ``sweep``) lay out the
reference's devices.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import fleet as JF
from repro.fleet.state import pack_carry as j_pack_carry

from repro_torch import fleet as PF
from repro_torch import telemetry as PT
from repro_torch.launch.mesh import make_fleet_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _workloads as W  # noqa: E402
from test_torch_fleet import (POLICIES, assert_result_equal,  # noqa: E402
                              port_cfg, port_harvester, port_statics,
                              port_tasks)
from _torch_threads import one_torch_thread  # noqa: E402,F401

HORIZON = 3.0


@pytest.fixture(scope="module")
def fleet_case():
    """The K = 2 task set on the intermittent harvester, all four policies
    at two etas; the JAX monolithic result and end carry beside it."""
    harv, _ = W.MODES["intermittent"]
    grid = JF.SweepGrid(task=W.random_task_set(W.TASK_SET_SEEDS[2], 2),
                        policies=POLICIES, etas=(0.5, 1.0),
                        harvesters=(harv,), horizon=HORIZON, dt=W.DT)
    cfg, statics, _ = JF.build(grid)
    ref, ref_carry = JF.run_segments(cfg, statics, 1)
    return cfg, statics, ref, ref_carry


def assert_carry_equal(port, ref, what=""):
    for f, a, b in zip(port._fields, port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{what}carry.{f}")


@pytest.mark.parametrize("n_segments", [1, 3, 7, 32])
def test_run_segments_bit_identical_to_monolithic(fleet_case, n_segments):
    """Chunked == monolithic for segment counts that do and do not divide
    the step count; the result and the end carry equal JAX's."""
    cfg, statics, ref, ref_carry = fleet_case
    mode = "fused" if n_segments % 2 else "vmap"
    res, carry = PF.run_segments(port_cfg(cfg), port_statics(statics),
                                 n_segments, mode=mode)
    assert_result_equal(res, ref)
    assert_carry_equal(carry, ref_carry)


@pytest.mark.parametrize("mode", ["vmap", "fused"])
def test_resume_mid_horizon(fleet_case, mode):
    """Half the horizon, then resume the carry at ``start_step``: lands
    bit-exactly on the JAX run, results and carry."""
    cfg, statics, ref, ref_carry = fleet_case
    pcfg, pst = port_cfg(cfg), port_statics(statics)
    half = dataclasses.replace(pst, horizon=HORIZON / 2)
    _, carry = PF.run_segments(pcfg, half, 2, mode=mode)
    res, carry = PF.run_segments(pcfg, pst, 2, carry=carry,
                                 start_step=half.n_steps, mode=mode)
    assert_result_equal(res, ref)
    assert_carry_equal(carry, ref_carry)


def test_hook_rewrites_eta_like_jax(fleet_case):
    """A hook that raises every device's eta after the second segment:
    the same boundaries (segment, t_end) and the same results and carry
    as the JAX runner with the same hook."""
    cfg, statics, _, _ = fleet_case
    seen = {"jax": [], "port": []}

    def j_hook(seg, t_end, c, carry):
        seen["jax"].append((seg, t_end))
        if seg == 1:
            return c._replace(eta=jnp.full_like(c.eta, 100.0))
        return None

    def p_hook(seg, t_end, c, carry):
        seen["port"].append((seg, t_end))
        assert carry.energy.shape == c.eta.shape
        if seg == 1:
            return c._replace(eta=torch.full_like(c.eta, 100.0))
        return None

    ref, ref_carry = JF.run_segments(cfg, statics, 4, hook=j_hook)
    res, carry = PF.run_segments(port_cfg(cfg), port_statics(statics), 4,
                                 hook=p_hook, mode="fused")
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 4
    assert_result_equal(res, ref)
    assert_carry_equal(carry, ref_carry)
    plain, _ = JF.run_segments(cfg, statics, 4)
    assert not all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(plain, ref))      # the hook mattered


def test_pack_carry_round_trip(fleet_case):
    """``pack_carry`` casts exactly the boolean leaves to int32, equals
    the reference's layout leaf for leaf, and ``unpack_carry`` inverts it;
    ``mesh=`` on a one-device mesh returns the same result and carry (the
    carry resumed over it too); ``telemetry=`` returns the same result
    and carry beside a telemetry, and ``telemetry_carry`` without it is
    the reference's ValueError."""
    cfg, statics, _, ref_carry = fleet_case
    _, carry = PF.run_segments(port_cfg(cfg), port_statics(statics), 2)
    packed = PF.pack_carry(carry)
    for f, a, b in zip(packed._fields, packed, j_pack_carry(ref_carry)):
        assert a.dtype == (torch.int32 if a.dtype != torch.float32
                           else torch.float32), f
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    back = PF.unpack_carry(packed)
    for f, a, b in zip(back._fields, back, carry):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    one = make_fleet_mesh(device="cpu")
    half = statics.n_steps // 2
    _, c_half = PF.run_segments(port_cfg(cfg), dataclasses.replace(
        port_statics(statics), horizon=half * statics.dt), 1)
    res_m, carry_m = PF.run_segments(port_cfg(cfg), port_statics(statics),
                                     2, carry=c_half, start_step=half,
                                     mesh=one)
    for f, a, b in zip(carry_m._fields, carry_m, carry):
        assert torch.equal(a, b), f
    assert_result_equal(res_m, JF.run_segments(cfg, statics, 1)[0])
    res, tcarry, tel = PF.run_segments(port_cfg(cfg), port_statics(statics),
                                       2, telemetry=PT.TelemetryConfig())
    for f, a, b in zip(tcarry._fields, tcarry, carry):
        assert torch.equal(a, b), f
    assert int(tel.c_release.sum()) == int(carry.next_rel.sum())
    assert int(tel.n_steps[0]) == statics.n_steps
    with pytest.raises(ValueError, match="telemetry_carry"):
        PF.run_segments(port_cfg(cfg), port_statics(statics), 1,
                        telemetry_carry=tel)
    with pytest.raises(ValueError, match="n_segments"):
        PF.run_segments(port_cfg(cfg), port_statics(statics), 0)


def test_sweep_builds_the_reference_grid():
    """``build``/``sweep`` lay out the same devices and metadata as the
    JAX builders; ``mesh=`` over a one-device mesh gives the same result;
    ``simulate_fleet(telemetry=)`` returns the same result beside its
    telemetry and is the reference's ValueError in the fused mode."""
    harv, _ = W.MODES["intermittent"]
    tasks = W.random_task_set(W.TASK_SET_SEEDS[2], 2)
    kw = dict(policies=("zygarde", "rr"), etas=(0.5, 1.0), seeds=(0, 1),
              horizon=1.0, dt=W.DT)
    jgrid = JF.SweepGrid(task=tasks, harvesters=(harv,), **kw)
    pgrid = PF.SweepGrid(task=port_tasks(tasks),
                         harvesters=(port_harvester(harv),), **kw)
    jcfg, jst, jmeta = JF.build(jgrid)
    pcfg, pst, pmeta = PF.build(pgrid, "cpu")
    assert pmeta == jmeta and pst == port_statics(jst)
    for f, a, b in zip(pcfg._fields, pcfg, jcfg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    res, meta = PF.sweep(pgrid, mode="fused", device="cpu")
    assert_result_equal(res, JF.sweep(jgrid)[0])
    res_m, meta_m = PF.sweep(pgrid, mesh=make_fleet_mesh(device="cpu"),
                             device="cpu")
    assert meta_m == pmeta
    assert_result_equal(res_m, JF.sweep(jgrid)[0])
    plain = PF.simulate_fleet(pcfg, pst)
    res_t, tel = PF.simulate_fleet(pcfg, pst, mode="pallas",
                                   telemetry=PT.TelemetryConfig(level="full"))
    assert_result_equal(res_t, JF.sweep(jgrid)[0])
    for f, a, b in zip(plain._fields, plain, res_t):
        assert torch.equal(a, b), f
    assert int(tel.c_release.sum()) == int(res_t.released.sum())
    with pytest.raises(ValueError, match="fused"):
        PF.simulate_fleet(pcfg, pst, telemetry=PT.TelemetryConfig(),
                          mode="fused")
    with pytest.warns(DeprecationWarning):
        PF.simulate_fleet(pcfg, pst, use_pallas=True)
    with pytest.raises(ValueError, match="mode"):
        PF.simulate_fleet(pcfg, pst, mode="scan")
