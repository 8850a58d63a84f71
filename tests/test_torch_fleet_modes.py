"""The port's replay fleet in its kernel modes against the JAX package.

``mode="pallas"`` (per-step pick through ``fleet_priority``) and
``mode="fused"`` (whole segments through ``fleet_fused_steps``) run the
kernels' plain versions here, on CPU tensors; every result leaf must equal
JAX ``simulate_fleet(mode="vmap")`` over the parity matrix (a third of its
horizon).  Each kernel's plain version is also held against the JAX kernel
it replaces, run as the JAX tests run it on the CPU (Pallas in interpret
mode) inside the program that calls it, so XLA compiles the surrounding
arithmetic as it does in the fleet.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import fleet as JF
from repro.core import step as JS
from repro.fleet.simulator import _pick_pallas, _scan_steps
from repro.kernels import ops as JO

from repro_torch import convert
from repro_torch import fleet as PF
from repro_torch.core import step as PSt
from repro_torch.kernels import fleet_priority as FP
from repro_torch.kernels import fleet_step as FS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _workloads as W  # noqa: E402
from test_torch_fleet import (  # noqa: E402
    POLICIES, SHORT, assert_result_equal, matrix_cfg, port_cfg, port_statics)
from _torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("k", sorted(W.TASK_SET_SEEDS))
def test_kernel_modes_match_jax(k):
    """``pallas`` and ``fused`` == JAX ``vmap`` on every result leaf, all
    four policies under both harvester modes."""
    cfg, statics = matrix_cfg(k, SHORT)
    ref = JF.simulate_fleet(cfg, statics)
    for mode in ("pallas", "fused"):
        out = PF.simulate_fleet(port_cfg(cfg), port_statics(statics),
                                mode=mode)
        assert_result_equal(out, ref, f"{mode}: ")
    assert int(out.units_executed.sum()) > 0


def test_odd_device_count_matches_jax():
    """A prime fleet size (7 devices) in the kernel modes: no padding, no
    cross-device effect — every leaf equals the JAX run."""
    cfg, statics = matrix_cfg(2, SHORT)
    cfg = jax.tree.map(lambda x: x[:7], cfg)
    ref = JF.simulate_fleet(cfg, statics)
    for mode in ("pallas", "fused"):
        out = PF.simulate_fleet(port_cfg(cfg), port_statics(statics),
                                mode=mode)
        assert out.released.shape == (7,)
        assert_result_equal(out, ref, f"{mode}: ")


def _task_set_grid(k):
    """``test_pallas_kernel_matches_jnp_on_task_sets``' grid."""
    harv, _ = W.MODES["intermittent"]
    grid = JF.SweepGrid(task=W.random_task_set(W.TASK_SET_SEEDS[k], k),
                        policies=POLICIES, etas=(0.5, 1.0),
                        harvesters=(harv,), horizon=W.HORIZON, dt=W.DT)
    cfg, statics, _ = JF.build(grid)
    return cfg, statics


def _to_port(tree, cls):
    return convert.named_tuple(cls, jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("nan_energy", [False, True],
                         ids=["finite", "nan-energy"])
def test_fleet_priority_plain_matches_jax_kernel(nan_energy):
    """Kernel A's plain version == JAX ``ops.fleet_priority`` (interpret
    mode, called as ``simulate_fleet(mode="pallas")`` calls it) on all four
    outputs, every 40 steps over the horizon of the K = 4 task-set grid;
    the per-slot inputs (the plain ``pick_inputs``) agree too.  With
    ``nan_energy`` every third device starts from a NaN charge, which the
    capacitor clamp keeps (``jnp.minimum`` / ``torch.minimum``): the NaNs
    sit in the same places (``assert_array_equal`` holds NaN to NaN)."""
    cfg, statics = _task_set_grid(4)
    pcfg, pst = port_cfg(cfg), port_statics(statics)

    @jax.jit
    def j_pick(cfg, states, i):
        t = i.astype(jnp.float32) * statics.dt
        states = jax.vmap(lambda c, s: JS.admit(c, s, t, statics))(cfg,
                                                                   states)
        states = jax.vmap(lambda c, s: JS.drop_expired(c, s, t))(cfg, states)
        ins = jax.vmap(lambda c, s: JS.pick_inputs(c, s, t, statics))(
            cfg, states)
        return states, ins, _pick_pallas(cfg, states, t, statics)

    states = JF.init_fleet(cfg, statics)
    if nan_energy:
        states = states._replace(energy=states.energy.at[::3].set(jnp.nan))
    n_picked, n_nan = 0, 0
    for i in range(0, statics.n_steps, 40):
        jst, jins, ref = j_pick(cfg, states, jnp.int32(i))
        st = _to_port(jst, PSt.DeviceCarry)
        t = PSt.step_clock(i, statics.dt, "cpu")
        ins = PSt.pick_inputs(pcfg, st, t, pst)
        for n, a, b in zip(("laxity", "utility", "mandatory", "gate_e",
                            "drain"), ins[:5], jins[:5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"step {i}: {n}")
        lax, util, mand, gate_e, drain, power, forced, _ = ins
        out = FP.fleet_priority(
            pcfg.policy, st.q_active, lax, st.q_release, util, mand,
            pcfg.alpha, pcfg.beta, pcfg.eta, pcfg.persistent, st.energy,
            pcfg.e_opt, power, pcfg.capacity, gate_e, drain, forced,
            st.q_task, st.rr_cursor, n_tasks=4, dt=pst.dt)
        for n, a, b in zip(("sel", "picked", "run", "e_new"), out, ref):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, n
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"step {i}: {n}")
        n_picked += int(out[1].sum())
        n_nan += int(out[3].isnan().sum())
        states = _scan_steps(cfg, states, jnp.int32(i), statics, 40, True)
    assert n_picked > 0
    assert (n_nan > 0) == nan_energy


def test_fleet_fused_plain_matches_jax_kernel():
    """Kernel B's plain version == JAX ``ops.fleet_fused_steps`` (interpret
    mode) and its vmap twin (``_scan_steps``) on every carry leaf, over a
    300-step segment from mid-horizon."""
    cfg, statics = _task_set_grid(2)
    i0, n = 900, 300
    states = _scan_steps(cfg, JF.init_fleet(cfg, statics), jnp.int32(0),
                         statics, i0, False)
    ref = JO.fleet_fused_steps(cfg, states, jnp.int32(i0), statics=statics,
                               n_steps=n)
    twin = _scan_steps(cfg, states, jnp.int32(i0), statics, n, False)
    out = FS.fleet_fused_steps(port_cfg(cfg),
                               _to_port(states, PSt.DeviceCarry), i0,
                               statics=port_statics(statics), n_steps=n)
    for f, a, b, c in zip(out._fields, out, ref, twin):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=f)
    assert bool(torch.any(out.m_units != _to_port(states,
                                                  PSt.DeviceCarry).m_units))
