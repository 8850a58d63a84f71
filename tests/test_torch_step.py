"""The PyTorch port's policy math and step core against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
reference is the JAX code as XLA compiles it on the CPU: ``policy_scores``
under ``jax.jit``, and the step core compiled whole as the fleet runs it
(``t = i * dt`` and ``t_end = (i + 1) * dt`` formed inside the program).
XLA contracts four multiply-adds of that program into one rounding (the
capacitor charge and three priority terms); the port forms exactly those
with one rounding (``repro_torch.core._fma``), so every leaf, ``energy``
included, must be bit-equal after every step.
"""
import sys
from fractions import Fraction
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
from repro_torch.core._fma import fma_f32
from repro_torch.core import step as PS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _workloads as W  # noqa: E402

from repro.core import energy as JE  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

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


def _exact_f32(x, y, z):
    """``x * y + z`` rounded once to f32, from exact rational arithmetic:
    the nearest of the f32 neighbours of the f64 sum, ties to even."""
    exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    r = np.float32(float(exact))
    best = None
    for c in (np.nextafter(r, np.float32(-np.inf)), r,
              np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - exact)
        even = int(np.array(c).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma_f32_is_correctly_rounded():
    """The port's f32 fused multiply-add against numpy float64 arithmetic
    on the hard cases — products that land exactly on an f32 midpoint,
    nudged by a far smaller addend (where a plain f64 sum rounded to f32
    rounds twice and goes the wrong way), and addends far larger or far
    smaller than the product — and against exact rational arithmetic on
    random inputs."""
    rng = np.random.default_rng(0)
    # (1 + a/2^12)(1 + b/2^12) with a, b odd: an odd numerator below 2^25
    # is exactly the midpoint of two f32 neighbours
    a = rng.integers(0, 2 ** 11, 4000) * 2 + 1
    b = rng.integers(0, 2 ** 11, 4000) * 2 + 1
    keep = (2 ** 12 + a) * (2 ** 12 + b) < 2 ** 25
    x = ((2 ** 12 + a[keep]) / 2 ** 12).astype(np.float32)
    y = ((2 ** 12 + b[keep]) / 2 ** 12).astype(np.float32)
    y = y * rng.choice([-1, 1], y.shape).astype(np.float32)
    p = x.astype(np.float64) * y.astype(np.float64)
    tiny = rng.choice([-1, 1], p.shape) * 2.0 ** rng.integers(-70, -40,
                                                              p.shape)
    z = tiny.astype(np.float32)
    t = p.astype(np.float32)                    # the tie, to even
    other = np.nextafter(t, np.where(t < p, np.inf, -np.inf).astype(
        np.float32))
    hi = np.maximum(t, other)
    lo = np.minimum(t, other)
    want = np.where(z > 0, hi, lo)
    got = fma_f32(torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the plain f64 sum rounded to f32 fails on these
    assert ((p + z).astype(np.float32) != want).sum() > 100

    # exponent gaps both ways, and random inputs, against exact arithmetic
    n = 3000
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    z = (rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    got = fma_f32(torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(z)).numpy()
    want = np.array([_exact_f32(*v) for v in zip(x, y, z)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # python-float constants are f32 constants
    assert fma_f32(torch.tensor([3.0]), 1e-9, 0.5).item() == _exact_f32(
        np.float32(3.0), np.float32(1e-9), np.float32(0.5))


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_policy_scores_match_jax(seed, persistent):
    """All four policies (mixed across devices), persistent (Eq. 6) and
    intermittent (Eq. 7) power: scores and thresholds bit-equal to the
    jitted JAX scores."""
    args = _policy_inputs(seed, persistent)
    ref = jax.jit(JP.policy_scores)(
        **{k: jnp.asarray(v) for k, v in args.items()})
    out = PP.policy_scores(**{k: torch.from_numpy(v)
                              for k, v in args.items()})
    for r, o in zip(ref, out):
        r = np.asarray(r)
        o = o.numpy()
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o.view(np.uint8), r.view(np.uint8))


# (task-set size, harvesters and etas of the grid, steps): the two task
# sets under battery and bursty power, and the 0.07 W rf harvester from a
# cold boot, where the capacitor energy crosses zero
_STEP_WORKLOADS = {
    "k1": (1, ("persistent", "bursty"), N_STEPS),
    "k2": (2, ("persistent", "bursty"), N_STEPS),
    "intermittent": (2, ("intermittent",), 300),
}


def _grid_modes(names):
    harvesters, etas = [], []
    for n in names:
        h, eta = (BURSTY, 0.7) if n == "bursty" else W.MODES[n]
        harvesters.append(h)
        etas.append(eta)
    return tuple(harvesters), tuple(sorted(set(etas)))


@pytest.mark.parametrize("workload", sorted(_STEP_WORKLOADS))
def test_device_step_matches_jax(workload):
    """Every policy, persistent and intermittent power (cold boot,
    reboots), stepped N times: every carry leaf bit-equal to the JAX step
    core compiled as the fleet runs it, after every step."""
    k, modes, n_steps = _STEP_WORKLOADS[workload]
    tasks = W.random_task_set(W.TASK_SET_SEEDS[k], k)
    harvesters, etas = _grid_modes(modes)
    grid = jfleet.SweepGrid(
        task=tasks, policies=("zygarde", "edf", "edf-m", "rr"),
        etas=etas, harvesters=harvesters, seeds=(0,),
        horizon=W.HORIZON, dt=W.DT)
    cfg, statics, _ = jfleet.build(grid)
    ref = jax.vmap(lambda c: JS.init_carry(c, statics))(cfg)
    step_jit = jax.jit(jax.vmap(
        lambda p, s, i: JS.device_step(
            p, s, i.astype(jnp.float32) * statics.dt, statics,
            t_end=(i + 1).astype(jnp.float32) * statics.dt),
        in_axes=(0, 0, None)))

    pcfg = convert.step_params(jax.tree.map(np.asarray, cfg), "cpu")
    pst = PS.StepStatics(statics.queue_size, statics.dt, statics.horizon,
                         statics.slot_s)
    st = PS.init_carry(pcfg, pst)
    for f, a, b in zip(st._fields, st, jax.tree.map(np.asarray, ref)):
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)

    for i in range(n_steps):
        t = np.float32(i) * np.float32(statics.dt)
        te = np.float32(i + 1) * np.float32(statics.dt)
        ref = step_jit(cfg, ref, jnp.int32(i))
        st = PS.device_step(pcfg, st, torch.tensor(t), pst,
                            t_end=torch.tensor(te))
        for f, a, b in zip(st._fields, st, jax.device_get(ref)):
            a = a.numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8),
                                          err_msg=f"step {i}: {f}")
    fin = PS.finalize(pcfg, st, pst)
    ref_fin = jax.vmap(lambda c, s: JS.finalize(c, s, statics))(cfg, ref)
    for f, a, b in zip(fin._fields, fin, ref_fin):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    # the workload exercises the transition: units run, jobs finish, and
    # the power-gated devices wait for energy
    assert int(fin.units_executed.sum()) > 0
    assert int(fin.scheduled.sum()) > 0
    assert float(fin.idle_no_energy.max()) > 0
