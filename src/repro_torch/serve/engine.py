"""Scalar serving engine: job queue + Zygarde scheduler + agile executor
(port of :mod:`repro.serve.engine`).

The single-device engine: the event-driven
:func:`repro_torch.core.scheduler.simulate` loop over one task set of
agile models, which *executes* each model unit by unit as the scheduler
picks it, with runtime centroid adaptation, so classification outcomes
depend on the order the scheduler chose.  Job profiles are lazy
(:class:`DynamicJobProfile`): unit ``u``'s utility-test outcome is
computed the first time the scheduler reads it.

Each executed unit classifies its features through the ``l1_topk2``
kernel (one row) and, at the job's first passed utility test, adapts the
unit's centroids through the ``centroid_update`` kernel and propagates
them to the deeper units.  The engine runs where the models' parameters
live; its host values (margins, passes, predictions) are read back once
per executed unit, as the reference reads them.

:class:`repro_torch.serve.fleet_engine.FleetServeEngine` is the
vectorized sibling, bit-exact against this engine on clock-commensurate
workloads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..core import kmeans as km
from ..core.energy import Capacitor, Harvester
from ..core.scheduler import SimConfig, SimResult, TaskSpec, simulate


class _LazyVec:
    """Array-like view that materialises per-unit results on first access."""

    def __init__(self, profile: "DynamicJobProfile", name: str):
        self._p = profile
        self._name = name

    def __getitem__(self, u):
        self._p._ensure(int(u))
        return getattr(self._p, "_" + self._name)[int(u)]

    def __len__(self):
        return self._p.n_units


class DynamicJobProfile:
    """Duck-typed :class:`repro_torch.core.scheduler.JobProfile` that runs
    the agile model lazily (with adaptation) as units are scheduled."""

    def __init__(self, model, x, label: int, *, adapt: bool = True,
                 adapt_weight: float = 32.0):
        self._model = model
        self._label = int(label)
        self._adapt = adapt
        self._adapt_weight = adapt_weight
        self._state = model._initial_state(x)
        self._exec_units = 0
        n = model.n_units
        self._margins = np.zeros(n)
        self._passes = np.zeros(n, bool)
        self._correct = np.zeros(n, bool)
        self._preds = np.full(n, -1, np.int64)
        self._exited = False
        self.margins = _LazyVec(self, "margins")
        self.passes = _LazyVec(self, "passes")
        self.correct = _LazyVec(self, "correct")

    @property
    def n_units(self) -> int:
        return self._model.n_units

    def _ensure(self, u: int) -> None:
        while self._exec_units <= u:
            i = self._exec_units
            self._state, feats = self._model._run_unit(self._state, i)
            uc = self._model.bank[i]
            pred, d1, d2, idx, margin = km.classify(uc, feats)
            m = float(margin[0])
            self._margins[i] = m
            ok = m > float(uc.threshold)
            self._passes[i] = ok
            self._preds[i] = int(pred[0])
            self._correct[i] = self._preds[i] == self._label
            if ok and not self._exited:
                self._exited = True
                if self._adapt:
                    self._model.bank[i] = km.adapt(
                        uc, feats, idx, weight=self._adapt_weight
                    )
                    self._model._propagate_from(i, idx)
            self._exec_units += 1

    def mandatory_units(self) -> int:
        for u in range(self.n_units):
            self._ensure(u)
            if self._passes[u]:
                return u + 1
        return self.n_units


@dataclass(frozen=True)
class Request:
    x: object            # model input (image / token sequence / batch dict)
    label: int
    release: float


@dataclass
class ServeConfig:
    policy: str = "zygarde"
    # period/deadline: one float shared by every task, or a sequence with
    # one entry per task (same order as the ``models`` list)
    period: object = 1.0
    deadline: object = 2.0
    unit_time: Optional[np.ndarray] = None      # seconds per unit
    unit_energy: Optional[np.ndarray] = None    # joules per unit
    fragments_per_unit: int = 4
    horizon: float = 600.0
    queue_size: int = 3
    adapt: bool = True
    seed: int = 0
    e_opt_fraction: float = 0.7
    # cold-boot control + the event loop's idle integration step; the fleet
    # serving parity workloads pin both (charged start, dt = one fragment)
    start_charged: bool = False
    sim_dt: Optional[float] = None


def per_task(value, n_tasks: int) -> list[float]:
    """Broadcast a scalar config value to ``n_tasks`` (or validate a
    per-task sequence)."""
    if np.ndim(value) == 0:
        return [float(value)] * n_tasks
    vals = [float(v) for v in np.asarray(value).ravel()]
    if len(vals) != n_tasks:
        raise ValueError(
            f"per-task config has {len(vals)} entries for {n_tasks} tasks")
    return vals


class ServeEngine:
    """End-to-end intermittent serving of one or more agile-model tasks on
    one device: the models run where their parameters live (every model on
    the same device)."""

    def __init__(
        self,
        models: Sequence,                 # agile frontends (one per task)
        harvester: Harvester,
        eta: float,
        cap: Optional[Capacitor] = None,
        config: Optional[ServeConfig] = None,
    ):
        self.models = list(models)
        devices = {str(m.device) for m in self.models}
        if len(devices) > 1:
            raise ValueError(
                f"ServeEngine: the models live on several devices "
                f"{sorted(devices)}")
        self.harvester = harvester
        self.eta = eta
        self.cap = cap or Capacitor()
        self.config = config or ServeConfig()

    def run(self, requests_per_task: Sequence[Sequence[Request]]) -> SimResult:
        cfg = self.config
        periods = per_task(cfg.period, len(self.models))
        deadlines = per_task(cfg.deadline, len(self.models))
        tasks = []
        for tid, (model, reqs) in enumerate(
            zip(self.models, requests_per_task)
        ):
            n_units = model.n_units
            ut = (
                cfg.unit_time if cfg.unit_time is not None
                else np.full(n_units, 0.2)
            )
            ue = (
                cfg.unit_energy if cfg.unit_energy is not None
                else np.full(n_units, 5e-3)
            )
            profiles = [
                DynamicJobProfile(model, r.x, r.label, adapt=cfg.adapt)
                for r in reqs
            ]
            tasks.append(
                TaskSpec(
                    task_id=tid,
                    period=periods[tid],
                    deadline=deadlines[tid],
                    unit_time=np.asarray(ut, float),
                    unit_energy=np.asarray(ue, float),
                    profiles=profiles,
                    fragments_per_unit=cfg.fragments_per_unit,
                )
            )
        sim = SimConfig(
            policy=cfg.policy,
            horizon=cfg.horizon,
            queue_size=cfg.queue_size,
            seed=cfg.seed,
            e_opt_fraction=cfg.e_opt_fraction,
            start_charged=cfg.start_charged,
        )
        if cfg.sim_dt is not None:
            sim.dt = float(cfg.sim_dt)
        res = simulate(tasks, self.harvester, self.eta, self.cap, sim)
        # kept for inspection: the live profiles carry the per-unit margins
        # and predictions the scheduler computed; the Job records back the
        # scalar side of the scalar <-> fleet parity checks
        self.tasks_ = tasks
        self.profiles_ = [t.profiles for t in tasks]
        self.jobs_ = getattr(res, "jobs", None)
        return res
