"""Workload and clock types of the imprecise real-time scheduler (paper §5).

Port of the type half of :mod:`repro.core.scheduler`: the dataclasses that
the fleet grid builder and the serving engine consume.  The event-driven
``simulate`` and the scalar ``simulate_stepped`` oracle are not part of
this slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class JobProfile:
    """Pre-computed per-sample execution profile (from the agile DNN).

    margins[u]  : utility-test margin after unit u
    passes[u]   : margin > threshold_u (would exit after unit u)
    correct[u]  : unit-u k-means prediction correct?
    """

    margins: np.ndarray
    passes: np.ndarray
    correct: np.ndarray

    @property
    def n_units(self) -> int:
        return len(self.margins)

    def mandatory_units(self) -> int:
        """Dynamic M: first unit whose utility test passes (1-based count)."""
        idx = np.flatnonzero(self.passes)
        return int(idx[0]) + 1 if len(idx) else self.n_units


@dataclass(frozen=True)
class TaskSpec:
    task_id: int
    period: float
    deadline: float               # relative deadline
    unit_time: np.ndarray         # (n_units,) seconds per unit
    unit_energy: np.ndarray       # (n_units,) joules per unit
    profiles: Sequence[JobProfile]
    fragments_per_unit: int = 4
    release_jitter: float = 0.0


class Clock:
    def read(self, t: float, rng: np.random.Generator) -> float:
        return t


class CHRTClock(Clock):
    """Tier-3 CHRT error model: 80% exact, ~17% +1s, rare +2s/-1s/-2s."""

    def __init__(self, p_exact=0.80, p_p1=0.17, p_p2=0.01, p_m1=0.015,
                 p_m2=0.005):
        self.choices = np.array([0.0, 1.0, 2.0, -1.0, -2.0])
        self.probs = np.array([p_exact, p_p1, p_p2, p_m1, p_m2])
        self.probs /= self.probs.sum()

    def read(self, t: float, rng: np.random.Generator) -> float:
        return t + rng.choice(self.choices, p=self.probs)

    def mean_error(self) -> float:
        """Expected per-read clock error (seconds)."""
        return float((self.choices * self.probs).sum())

    def equivalent_drift(self, horizon: float) -> float:
        """Constant drift *rate* for the fleet path's deterministic clock
        model ``t_read = t * (1 + r)``: matching the time-averaged error
        over ``[0, horizon]`` (``r * horizon / 2``) gives
        ``r = 2 * E[err] / horizon``."""
        return 2.0 * self.mean_error() / float(horizon)


@dataclass
class SimConfig:
    policy: str = "zygarde"       # zygarde | edf | edf-m | rr
    horizon: float = 600.0
    dt: float = 0.05              # integration step while idle/off
    e_man: Optional[float] = None # default: max fragment energy
    e_opt_fraction: float = 0.7   # E_opt as fraction of capacitor capacity
    queue_size: int = 3
    seed: int = 0
    clock: Clock = field(default_factory=Clock)
    start_charged: bool = False
