"""Serving configuration types (port of the part of :mod:`repro.serve.engine`
that the fleet engine needs: ``Request``, ``ServeConfig``, ``per_task``).

The scalar event-driven ``ServeEngine`` and its lazy ``DynamicJobProfile``
need the event-driven ``simulate`` and come with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


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
