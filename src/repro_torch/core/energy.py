"""Intermittent-energy modeling (paper §3): energy events, conditional energy
events h(N), Kantorovich-Wasserstein distance, and the eta-factor; plus the
harvester/capacitor simulation substrate and the schedulability condition
(paper §5.3).

An *energy event* H_t in {0,1} says whether the storage gained at least
Delta-K joules during slot t.  Harvesters are bursty: h(N) — the probability
of an event given N consecutive preceding events (N>0) or non-events (N<0) —
decays with |N|.  eta in [0,1] normalises the KW distance of the h(N) curve
from a persistent source against a purely random one (Eq. 3).
"""
from __future__ import annotations

# Port note: a verbatim numpy copy of ``repro.core.energy`` (the port may not
# import the JAX package, not even its numpy-only modules).

from dataclasses import dataclass
from typing import Optional

import numpy as np

# --------------------------------------------------------------------------- #
# Conditional energy events and the eta-factor (Eqs. 1-3).
# --------------------------------------------------------------------------- #


def conditional_energy_event(trace: np.ndarray, n: int) -> float:
    """h(N) per Eq. 1.  trace: binary array of energy events; n != 0."""
    trace = np.asarray(trace, dtype=np.int8)
    assert n != 0
    run = abs(n)
    if len(trace) <= run:
        return np.nan
    target = 1 if n > 0 else 0
    # windows of length `run` ending at t-1 that are all == target
    ok = np.ones(len(trace) - run, dtype=bool)
    for i in range(run):
        ok &= trace[i : i + len(trace) - run] == target
    follow = trace[run:]
    if ok.sum() == 0:
        return np.nan
    return float(follow[ok].mean())


def h_curve(trace: np.ndarray, n_max: int = 20) -> np.ndarray:
    """h(N) for N in [-n_max..-1, 1..n_max] (NaN where unobserved)."""
    ns = list(range(-n_max, 0)) + list(range(1, n_max + 1))
    return np.array([conditional_energy_event(trace, n) for n in ns])


def ideal_h_curve(n_max: int = 20) -> np.ndarray:
    """h(N) of a perfectly state-maintaining ("persistent-pattern") source:
    after N consecutive events the next is certain (h=1); after N consecutive
    non-events the next event never happens (h=0).  This is the ideal
    *predictability* reference of Eq. 2 — Fig. 4(a)'s persistent source is
    the N>0 half of it (the N<0 half is unobservable there)."""
    return np.concatenate([np.zeros(n_max), np.ones(n_max)])


def random_h_curve(n_max: int = 20) -> np.ndarray:
    """A patternless harvester: h(N) = 1/2 everywhere."""
    return np.full(2 * n_max, 0.5)


def kw_distance(h_a: np.ndarray, h_b: np.ndarray) -> float:
    """Kantorovich-Wasserstein distance between two h(N) curves (Eq. 2):
    the L1 distance between their (normalised) cumulative curves over N.

    Using cumulative-over-N (a discrete CDF integral) rather than pointwise
    L1 makes the metric robust to N-bins estimated from few instances — the
    limitation the paper notes before normalising into eta.
    """
    a = np.asarray(h_a, np.float64)
    b = np.asarray(h_b, np.float64)
    mask = np.isfinite(a) & np.isfinite(b)
    if not mask.any():
        return 0.0
    a, b = a[mask], b[mask]
    ca = np.cumsum(a) / len(a)
    cb = np.cumsum(b) / len(b)
    return float(np.abs(ca - cb).mean())


def eta_factor(trace: np.ndarray, n_max: int = 20) -> float:
    """Eq. 3: eta = 1 - KW(H, P) / KW(R, P), clipped to [0, 1].

    eta = 1 for a persistent source, 0 for a patternless one; for a
    symmetric bursty (Markov) harvester with stay-probability p it grows
    monotonically with p (~ 2p - 1).  Only N-bins actually observed in the
    trace participate (the paper's "not all h(N) estimated from the same
    number of instances" normalisation concern)."""
    h = h_curve(trace, n_max)
    persistent = ideal_h_curve(n_max)
    rand = random_h_curve(n_max)
    obs = np.isfinite(h)
    persistent = np.where(obs, persistent, np.nan)
    rand = np.where(obs, rand, np.nan)
    denom = kw_distance(rand, persistent)
    if denom <= 0:
        return 1.0
    eta = 1.0 - kw_distance(h, persistent) / denom
    return float(np.clip(eta, 0.0, 1.0))


# --------------------------------------------------------------------------- #
# Harvester models (simulation substrate; §7's solar / RF / piezo setups).
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Harvester:
    """Two-state bursty (Markov) harvester.

    p_stay_on / p_stay_off: probability of keeping the current binary state
    in the next slot — burstiness, the empirical property behind eta.
    power_on: average harvesting power (W) while in the ON state.
    """

    name: str
    p_stay_on: float
    p_stay_off: float
    power_on: float
    slot_s: float = 1.0

    def sample_events(self, rng: np.random.Generator, n_slots: int,
                      init: Optional[int] = None) -> np.ndarray:
        u = rng.random(n_slots)
        out = np.empty(n_slots, dtype=np.int8)
        state = rng.integers(0, 2) if init is None else init
        for t in range(n_slots):
            stay = self.p_stay_on if state else self.p_stay_off
            if u[t] > stay:
                state = 1 - state
            out[t] = state
        return out

    def power_trace(self, rng: np.random.Generator, n_slots: int) -> np.ndarray:
        return self.sample_events(rng, n_slots).astype(np.float64) * self.power_on


PERSISTENT = Harvester("battery", 1.0, 0.0, 1.0)


def calibrate_harvester(
    target_eta: float, power_on: float, name: str = "harvester",
    n_slots: int = 20_000, seed: int = 0,
) -> Harvester:
    """Binary-search the Markov stay-probability to hit a target eta."""
    if target_eta >= 0.999:
        return Harvester(name, 1.0, 0.0, power_on)
    lo, hi = 0.5, 0.9999
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        h = Harvester(name, mid, mid, power_on)
        e = float(np.mean([
            eta_factor(h.sample_events(np.random.default_rng(seed + s),
                                       n_slots))
            for s in range(3)
        ]))
        if e < target_eta:
            lo = mid
        else:
            hi = mid
    p = 0.5 * (lo + hi)
    return Harvester(name, p, p, power_on)


# --------------------------------------------------------------------------- #
# Capacitor energy storage.
# --------------------------------------------------------------------------- #


@dataclass
class Capacitor:
    """Supercapacitor: E = 1/2 C V^2 between v_min (cutoff) and v_max."""

    capacitance_f: float = 0.05  # 50 mF, the paper's default
    v_max: float = 3.3
    v_min: float = 1.8
    energy_j: float = 0.0

    @property
    def capacity_j(self) -> float:
        return 0.5 * self.capacitance_f * (self.v_max ** 2 - self.v_min ** 2)

    def charge(self, joules: float) -> float:
        """Add harvested energy; returns the amount actually stored."""
        room = self.capacity_j - self.energy_j
        add = min(max(joules, 0.0), room)
        self.energy_j += add
        return add

    def discharge(self, joules: float) -> bool:
        """Spend energy; False (and no change) if insufficient."""
        if joules > self.energy_j:
            return False
        self.energy_j -= joules
        return True

    @property
    def full(self) -> bool:
        return self.energy_j >= self.capacity_j - 1e-12


def optimal_capacitance(
    avg_power_w: float, slack_s: float, v: float = 3.3
) -> float:
    """Paper §8.6: C = sqrt(2 P deltaT / V^2) (rough estimate)."""
    return float(np.sqrt(2.0 * avg_power_w * slack_s / v ** 2))


# --------------------------------------------------------------------------- #
# Schedulability (paper §5.3).
# --------------------------------------------------------------------------- #


def expected_outage_slots(eta: float) -> float:
    """E[C_e] = eta / (1 - eta) (geometric)."""
    eta = min(eta, 1 - 1e-9)
    return eta / (1.0 - eta)


def min_energy_task_period(eta: float, utilization: float) -> float:
    """Necessary condition: T_E >= (eta/(1-eta)) / (1 - sum C_i/T_i)."""
    if utilization >= 1.0:
        return float("inf")
    return expected_outage_slots(eta) / (1.0 - utilization)


def is_schedulable(
    mandatory_utils: list[float], eta: float, energy_task_period: float
) -> bool:
    """N+1-task condition: sum C_i/T_i + C_e/T_e <= 1."""
    u = sum(mandatory_utils)
    c_e = expected_outage_slots(eta)
    return u + c_e / energy_task_period <= 1.0
