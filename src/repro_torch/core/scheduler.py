"""Workload and clock types of the imprecise real-time scheduler (paper §5).

Port of :mod:`repro.core.scheduler`: the dataclasses that the fleet grid
builder and the serving engine consume, :class:`SimResult`, and the
fixed-step single-device frontend :func:`simulate_stepped` over the step
core.  The event-driven ``simulate`` (and its ``Job``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
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


@dataclass
class SimResult:
    released: int = 0
    scheduled: int = 0            # mandatory complete before deadline
    correct: int = 0              # scheduled AND final prediction correct
    deadline_misses: int = 0
    units_executed: int = 0
    optional_units: int = 0
    busy_time: float = 0.0
    idle_no_energy: float = 0.0
    reboots: int = 0
    wasted_reexec: float = 0.0
    sim_time: float = 0.0
    # per-task breakdowns, (K,) int arrays aligned with the ``tasks``
    # argument (the aggregate counters above are their sums)
    task_released: Optional[np.ndarray] = None
    task_scheduled: Optional[np.ndarray] = None
    task_correct: Optional[np.ndarray] = None
    task_misses: Optional[np.ndarray] = None

    def as_dict(self) -> dict:
        return {k: v.tolist() if isinstance(v, np.ndarray) else v
                for k, v in dataclasses.asdict(self).items()}


def simulate_stepped(tasks: Sequence[TaskSpec], harvester, eta: float,
                     cap=None, sim: Optional[SimConfig] = None,
                     dt: Optional[float] = None,
                     device="cuda") -> SimResult:
    """Fixed-step single-device frontend over the step core: the device of
    :func:`repro_torch.fleet.grid.from_sim_config` run by
    :func:`repro_torch.core.step.simulate_device` on ``device``.  ``dt``
    defaults to one fragment time of the finest-grained task."""
    from ..fleet.grid import from_sim_config
    from .step import simulate_device

    cfg, statics = from_sim_config(tasks, harvester, eta, cap=cap, sim=sim,
                                   dt=dt, device=device)
    params = type(cfg)(*[leaf[0] for leaf in cfg])   # strip the device axis
    r = simulate_device(params, statics)
    return SimResult(
        released=int(r.released),
        scheduled=int(r.scheduled),
        correct=int(r.correct),
        deadline_misses=int(r.deadline_misses),
        units_executed=int(r.units_executed),
        optional_units=int(r.optional_units),
        busy_time=float(r.busy_time),
        idle_no_energy=float(r.idle_no_energy),
        reboots=int(r.reboots),
        wasted_reexec=float(r.wasted_reexec),
        sim_time=float(r.sim_time),
        task_released=r.task_released.cpu().numpy().astype(np.int64),
        task_scheduled=r.task_scheduled.cpu().numpy().astype(np.int64),
        task_correct=r.task_correct.cpu().numpy().astype(np.int64),
        task_misses=r.task_misses.cpu().numpy().astype(np.int64),
    )
