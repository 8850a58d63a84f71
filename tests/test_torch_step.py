"""The PyTorch port's policy math and step core against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
port forms every product and sum as its own f32 rounding.  XLA on the CPU
contracts some ``a * b + c`` into one fused multiply-add when it compiles a
whole step (the capacitor update ``min(energy + amp * power_on * dt,
capacity)`` and the priority sums), so the exact reference runs the JAX
step core stage by stage: ``admit``, ``drop_expired``, ``pick_inputs`` and
``apply_step`` compiled one by one (no product meets a sum inside them),
and the priority scores and the capacitor update op by op.  Every leaf must
be bit-equal to it.  Against the whole step compiled as the fleet runs it,
the integer and boolean leaves must still be exact and only ``energy`` may
differ, by at most the measured ulp gap.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import fleet as jfleet
from repro.core import policy as JP
from repro.core import step as JS

from repro_torch import convert
from repro_torch.core import policy as PP
from repro_torch.core import step as PS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _workloads as W  # noqa: E402

from repro.core import energy as JE  # noqa: E402

# measured gap of the one leaf the compiled reference contracts (energy),
# over these workloads and step counts
ENERGY_ULP_GAP = 2
N_STEPS = 240
# a bursty harvester strong enough to pay the cold-boot debt within the
# stepped window, so power-gated picks and reboots happen in it
BURSTY = JE.Harvester("rf-strong", 0.93, 0.93, 0.7)


def _policy_inputs(seed, persistent):
    rng = np.random.default_rng(seed)
    D, Q = 512, 5

    def f(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return dict(
        policy_id=rng.integers(0, 4, (D, 1)).astype(np.int32),
        active=rng.random((D, Q)) < 0.7,
        laxity=f(-3, 3, D, Q),
        release=f(0, 50, D, Q),
        utility=f(0, 1, D, Q),
        mandatory=rng.random((D, Q)) < 0.5,
        alpha=f(0.1, 1, D, 1),
        beta=f(0.5, 1.5, D, 1),
        eta=f(0, 1, D, 1),
        energy=f(0, 0.2, D, 1),
        e_opt=f(0, 0.2, D, 1),
        persistent=np.full((D, 1), persistent),
        task_rank=rng.integers(0, 3, (D, Q)).astype(np.float32),
    )


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_policy_scores_match_jax(seed, persistent):
    """All four policies (mixed across devices), persistent (Eq. 6) and
    intermittent (Eq. 7) power: scores and thresholds bit-equal."""
    args = _policy_inputs(seed, persistent)
    ref = JP.policy_scores(**{k: jnp.asarray(v) for k, v in args.items()})
    out = PP.policy_scores(**{k: torch.from_numpy(v)
                              for k, v in args.items()})
    for r, o in zip(ref, out):
        r = np.asarray(r)
        o = o.numpy()
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o.view(np.uint8), r.view(np.uint8))


def _ulp_gap(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("k", [1, 2])
def test_device_step_matches_jax(k):
    """Every policy, persistent and intermittent power (cold boot,
    reboots), stepped N_STEPS times: every carry leaf bit-equal to the JAX
    step core after every step; against the compiled JAX step only the
    contracted ``energy`` leaf may differ, within ENERGY_ULP_GAP."""
    tasks = W.random_task_set(W.TASK_SET_SEEDS[k], k)
    h_p, eta_p = W.MODES["persistent"]
    grid = jfleet.SweepGrid(
        task=tasks, policies=("zygarde", "edf", "edf-m", "rr"),
        etas=(eta_p, 0.7), harvesters=(h_p, BURSTY), seeds=(0,),
        horizon=W.HORIZON, dt=W.DT)
    cfg, statics, _ = jfleet.build(grid)
    ref = jax.vmap(lambda c: JS.init_carry(c, statics))(cfg)
    ref_jit = ref
    step_jit = jax.jit(jax.vmap(
        lambda p, s, t, te: JS.device_step(p, s, t, statics, t_end=te),
        in_axes=(0, 0, None, None)))
    admit = jax.jit(lambda p, s, t: JS.admit(p, s, t, statics))
    expire = jax.jit(JS.drop_expired)
    inputs = jax.jit(lambda p, s, t: JS.pick_inputs(p, s, t, statics))
    apply = jax.jit(lambda p, s, t, a, pk, r, e, te: JS.apply_step(
        p, s, t, a, pk, r, e, statics, t_end=te))

    def ref_step(p, s, t, te):
        s = expire(p, admit(p, s, t), t)
        (lax_, util, mand, gate_e, drain, charge, forced,
         rank) = inputs(p, s, t)
        scores, thr = JP.policy_scores(
            p.policy[:, None], s.q_active, lax_, s.q_release, util, mand,
            p.alpha[:, None], p.beta[:, None], p.eta[:, None],
            s.energy[:, None], p.e_opt[:, None], p.persistent[:, None],
            rank)
        sel, picked, run, e_new = JS.select_and_charge(
            scores, thr[:, 0], forced, s.energy, charge, p.capacity,
            gate_e, drain)
        return apply(p, s, t, sel, picked, run, e_new, te)

    pcfg = convert.step_params(jax.tree.map(np.asarray, cfg), "cpu")
    pst = PS.StepStatics(statics.queue_size, statics.dt, statics.horizon,
                         statics.slot_s)
    st = PS.init_carry(pcfg, pst)
    for f, a, b in zip(st._fields, st, jax.tree.map(np.asarray, ref)):
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)

    gap = 0
    for i in range(N_STEPS):
        t = np.float32(i) * np.float32(statics.dt)
        te = np.float32(i + 1) * np.float32(statics.dt)
        ref = ref_step(cfg, ref, jnp.float32(t), jnp.float32(te))
        ref_jit = step_jit(cfg, ref_jit, jnp.float32(t), jnp.float32(te))
        st = PS.device_step(pcfg, st, torch.tensor(t), pst,
                            t_end=torch.tensor(te))
        for f, a, b, c in zip(st._fields, st, jax.device_get(ref),
                              jax.device_get(ref_jit)):
            a = a.numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8),
                                          err_msg=f"step {i}: {f}")
            if f == "energy":
                gap = max(gap, _ulp_gap(a, c))
            else:
                np.testing.assert_array_equal(
                    a.view(np.uint8), c.view(np.uint8),
                    err_msg=f"step {i}: {f} (compiled reference)")
    assert gap <= ENERGY_ULP_GAP
    fin = PS.finalize(pcfg, st, pst)
    ref_fin = jax.vmap(lambda c, s: JS.finalize(c, s, statics))(cfg, ref)
    for f, a, b in zip(fin._fields, fin, ref_fin):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    # the workload exercises the transition: units run, jobs finish, and
    # the bursty devices wait for energy
    assert int(fin.units_executed.sum()) > 0
    assert int(fin.scheduled.sum()) > 0
    assert float(fin.idle_no_energy.max()) > 0
