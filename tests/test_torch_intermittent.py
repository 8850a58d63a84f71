"""The port's intermittent execution substrate against the JAX package, and
its SONIC-style contract: a run with power failures equals a run without
them, bit for bit.

``run_intermittent`` is host code over the port's harvester and capacitor;
on the same fragments, seed and supply it must give the same ``RunStats``
as the reference, field by field.  A committed FRAM snapshot must survive
an in-place write to a tensor leaf (a torch tensor, unlike a JAX array, is
mutable).
"""
import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_fallback import given, settings, st

import jax.numpy as jnp

from repro.core import energy as JE
from repro.core import intermittent as JI

from repro_torch.core import energy as PE
from repro_torch.core import intermittent as PI
from repro_torch.models import cnn as PC
from _torch_threads import one_torch_thread  # noqa: F401

PERSISTENT = PE.Harvester("battery", 1.0, 0.0, 10.0)


def counter_fragments(pkg=PI, n=8, time_s=0.05, energy_j=2e-3, xp=torch):
    """n fragments, each appends its index and updates a running hash."""
    frags = []
    for i in range(n):
        def fn(state, i=i):
            return {
                "seq": state["seq"] + [i],
                "acc": state["acc"] * 31 + i,
                "arr": state["arr"] + xp.asarray(float(i), dtype=xp.float32),
            }
        frags.append(pkg.Fragment(fn, time_s, energy_j, f"f{i}"))
    return frags


def init_state(xp=torch):
    return {"seq": [], "acc": 7, "arr": xp.zeros((4,), dtype=xp.float32)}


def _assert_same_state(out, ref):
    assert out["seq"] == ref["seq"]
    assert out["acc"] == ref["acc"]
    np.testing.assert_array_equal(np.asarray(out["arr"]),
                                  np.asarray(ref["arr"]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("p_on,p_off,power", [(0.7, 0.7, 0.06),
                                              (0.6, 0.6, 0.05),
                                              (1.0, 0.0, 10.0)])
def test_run_stats_match_jax(seed, p_on, p_off, power):
    """The same fragments, supply and seed: the port's RunStats equal the
    reference's field by field, and the outputs are equal."""
    n, e = 10, 4e-2
    jh = JE.Harvester("h", p_on, p_off, power)
    ph = PE.Harvester("h", p_on, p_off, power)
    ref, rstats = JI.run_intermittent(
        counter_fragments(JI, n, energy_j=e, xp=jnp), init_state(jnp), jh,
        JE.Capacitor(capacitance_f=0.02), seed=seed, max_wall=1e4)
    out, stats = PI.run_intermittent(
        counter_fragments(PI, n, energy_j=e), init_state(), ph,
        PE.Capacitor(capacitance_f=0.02), seed=seed, max_wall=1e4)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    _assert_same_state(out, ref)
    if p_on < 1.0:
        assert stats.reboots > 0


def test_persistent_run_completes():
    out, stats = PI.run_intermittent(counter_fragments(), init_state(),
                                     PERSISTENT)
    assert out["seq"] == list(range(8))
    assert stats.reboots == 0
    assert stats.fragments_run == 8
    assert stats.off_time == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_failure_run_bit_exact(seed):
    """The central idempotence contract: intermittent result == persistent."""
    frags = counter_fragments(n=10, energy_j=4e-2)
    ref, _ = PI.run_intermittent(frags, init_state(), PERSISTENT)
    weak = PE.Harvester("weak", 0.7, 0.7, 0.06)
    out, stats = PI.run_intermittent(
        frags, init_state(), weak, PE.Capacitor(capacitance_f=0.02),
        seed=seed, max_wall=1e4)
    _assert_same_state(out, ref)
    assert torch.equal(out["arr"], ref["arr"])
    assert stats.fragments_run == 10


@given(st.integers(0, 500), st.floats(0.55, 0.95), st.floats(0.02, 0.2))
@settings(max_examples=15, deadline=None)
def test_idempotence_property(seed, p_stay, power):
    frags = counter_fragments(n=6, energy_j=2.5e-2)
    ref, _ = PI.run_intermittent(frags, init_state(), PERSISTENT)
    harv = PE.Harvester("h", p_stay, p_stay, power)
    out, stats = PI.run_intermittent(
        frags, init_state(), harv, PE.Capacitor(capacitance_f=0.02),
        seed=seed, max_wall=2e4)
    if stats.fragments_run == 6:  # completed within the wall-clock budget
        assert out["seq"] == ref["seq"]
        assert out["acc"] == ref["acc"]
        assert torch.equal(out["arr"], ref["arr"])
    assert stats.busy_time <= stats.wall_time + 1e-9


def test_committed_snapshot_survives_in_place_writes():
    """A fragment that writes its input tensor in place cannot reach the
    committed snapshot, nor what a restore hands back."""
    fram = PI.FRAMStore()
    state = {"x": torch.zeros(3), "meta": (1, [torch.ones(2)]),
             "n": np.zeros(2)}
    fram.commit("job", state)
    state["x"].add_(5.0)
    state["meta"][1][0].mul_(7.0)
    state["n"][0] = 9.0
    snap = fram.restore("job")
    assert torch.equal(snap["x"], torch.zeros(3))
    assert torch.equal(snap["meta"][1][0], torch.ones(2))
    assert snap["meta"][0] == 1 and snap["n"][0] == 0.0
    snap["x"].add_(1.0)
    assert torch.equal(fram.restore("job")["x"], torch.zeros(3))
    assert fram.commits == 1


def test_in_place_fragments_rerun_from_the_snapshot():
    """Fragments that update their state in place still give the persistent
    result under power failures: each reboot resumes from a copy of the
    last commit."""
    def frags():
        out = []
        for i in range(8):
            def fn(s, i=i):
                s["acc"].mul_(3.0).add_(float(i))
                return s
            out.append(PI.Fragment(fn, 0.05, 4e-2, f"f{i}"))
        return out

    ref, _ = PI.run_intermittent(frags(), {"acc": torch.ones(2)},
                                 PERSISTENT)
    out, stats = PI.run_intermittent(
        frags(), {"acc": torch.ones(2)}, PE.Harvester("weak", 0.7, 0.7, 0.06),
        PE.Capacitor(capacitance_f=0.02), seed=2, max_wall=1e4)
    assert stats.reboots > 0 and stats.fragments_reexecuted >= 0
    assert torch.equal(out["acc"], ref["acc"])


def test_fragment_unit_splits_costs():
    calls = []
    frags = PI.fragment_unit(lambda s: calls.append(1) or s + 1, 4, 0.4,
                             8e-3)
    assert len(frags) == 4
    assert sum(f.time_s for f in frags) == pytest.approx(0.4)
    assert sum(f.energy_j for f in frags) == pytest.approx(8e-3)
    out, _ = PI.run_intermittent(frags, 0, PERSISTENT)
    assert out == 1 and calls == [1]  # unit function applied exactly once


def test_cnn_units_under_power_failures():
    """Each unit of a small agile CNN cut into 4 fragments: one request
    through them under a weak harvester equals the run under a persistent
    supply, tensor for tensor, with the same fragment count."""
    cfg = PC.CNNConfig("tiny", (16, 16, 1), ((4, 5, True), (8, 5, True)),
                       (16,), 3)
    params = PC.init_cnn_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 1)).astype(
        np.float32)
    frags = []
    for u in range(cfg.n_units):
        def unit(s, u=u):
            h, f = PC.cnn_unit_forward(cfg, params, s["h"], u)
            return {"h": h, "feats": s["feats"] + [f]}
        frags += PI.fragment_unit(unit, 4, 0.2, 4e-2, name=f"unit{u}")
    state0 = {"h": torch.from_numpy(x), "feats": []}
    ref, rs = PI.run_intermittent(frags, state0, PERSISTENT)
    out, st_ = PI.run_intermittent(
        frags, state0, PE.Harvester("weak", 0.7, 0.7, 0.05),
        PE.Capacitor(capacitance_f=0.02), seed=1, max_wall=1e4)
    assert st_.reboots > 0
    assert st_.fragments_run == rs.fragments_run == 4 * cfg.n_units
    assert torch.equal(out["h"], ref["h"])
    for a, b in zip(out["feats"], ref["feats"]):
        assert torch.equal(a, b)
