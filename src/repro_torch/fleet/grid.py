"""Host-side (numpy) builders for the fleet configuration tensors (port of
:mod:`repro.fleet.grid`).

They translate :class:`repro_torch.core.scheduler.TaskSpec` task sets,
:class:`repro_torch.core.energy.Harvester` and ``Capacitor`` objects into
per-device numpy dicts, and :func:`stack_configs` stacks those into one
:class:`repro_torch.fleet.state.FleetConfig` of ``(D, ...)`` tensors.  The
per-task tables land on a ``K`` axis, padded to common ``U`` (units) /
``J`` (jobs); per-task ``n_units`` / ``n_releases`` bound the live region.

The cartesian sweep (:class:`SweepGrid`, :func:`build`, :func:`sweep`)
mirrors the paper's benchmark grids (Figs. 17-21, 24-25): policy x eta x
harvester x capacitor x seed, one device per grid point, all simulated by
one :func:`repro_torch.fleet.simulator.simulate_fleet` call.
:func:`from_sim_config` is the one-device bridge from the scalar
``SimConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core import policy as P
from ..core.energy import PERSISTENT, Capacitor, Harvester
from ..core.scheduler import Clock, SimConfig, TaskSpec
from .state import FleetConfig, FleetStatics

_F32 = np.float32

TaskSet = Union[TaskSpec, Sequence[TaskSpec]]


def as_task_set(tasks: TaskSet) -> tuple[TaskSpec, ...]:
    """Normalise a single TaskSpec or a sequence of them to a tuple."""
    if isinstance(tasks, TaskSpec):
        return (tasks,)
    out = tuple(tasks)
    if not out:
        raise ValueError("empty task set")
    if len({t.task_id for t in out}) != len(out):
        raise ValueError("task_ids within one task set must be unique")
    return out


def _n_releases(task: TaskSpec, horizon: float) -> int:
    # replicates the scalar release loop bit-for-bit — including its float
    # *accumulation* of t += period, which can slip one extra release under
    # the horizon when the period is not exactly representable (e.g. 1.2 s
    # accumulated 10× is 11.999999999999998 < 12.0, where the closed-form
    # ceil(horizon / period) says 10)
    t, j = 0.0, 0
    while t < horizon and j < len(task.profiles):
        t += task.period
        j += 1
    return j


def _check_dt(dt: float, tasks: TaskSet) -> float:
    """The fixed timestep must stay within one fragment time of every task
    (else a step's continuous drain exceeds the energy gate and the
    capacitor goes negative) and below every period (admission is one job
    per task per step)."""
    tasks = as_task_set(tasks)
    frag_t = min(
        float(np.min(np.asarray(t.unit_time)) / t.fragments_per_unit)
        for t in tasks)
    if dt > frag_t * (1 + 1e-9):
        raise ValueError(
            f"dt={dt} exceeds one fragment time ({frag_t}); the energy gate "
            "only covers one fragment of drain per step")
    if dt >= min(t.period for t in tasks):
        raise ValueError("dt must be smaller than every task period")
    return dt


def _default_dt(tasks: TaskSet) -> float:
    """One fragment time of the finest-grained task — the scalar path's
    execution quantum."""
    return min(
        float(np.min(np.asarray(t.unit_time)) / t.fragments_per_unit)
        for t in as_task_set(tasks))


def _pad_trailing(a: np.ndarray, shape: tuple, edge_axes: tuple) -> np.ndarray:
    """Zero/edge-pad ``a`` up to ``shape``; axes in ``edge_axes`` replicate
    the last valid entry (keeps padded unit times nonzero so the drain
    division in the simulator stays finite — the padding is never read by an
    active queue slot)."""
    widths = [(0, s - d) for s, d in zip(shape, a.shape)]
    if not any(w for _, w in widths):
        return a
    if edge_axes:
        a = np.pad(a, [w if i in edge_axes else (0, 0)
                       for i, w in enumerate(widths)], mode="edge")
        widths = [(0, s - d) for s, d in zip(shape, a.shape)]
    return np.pad(a, widths, mode="constant")


def device_config(
    tasks: TaskSet,
    harvester: Harvester,
    eta: float,
    cap: Capacitor,
    *,
    policy: str,
    horizon: float,
    events: np.ndarray,
    e_opt_fraction: float = 0.7,
    e_man: Optional[float] = None,
    start_charged: bool = False,
    clock_drift: float = 0.0,
    exit_thresholds: Optional[np.ndarray] = None,
) -> dict:
    """One device's configuration as a dict of (unbatched) numpy arrays.

    ``tasks`` is the device's task set (one TaskSpec or a sequence); the
    per-task tables land on a leading ``K`` axis.  ``clock_drift`` is the
    fleet CHRT model's linear drift rate (0 = exact RTC).
    ``exit_thresholds`` (shape ``(U,)`` shared by every task, or ``(K, U)``
    per task) switches the utility test from the precomputed ``passes``
    table to a live margin-vs-threshold comparison — the knob
    :mod:`repro.adapt` tunes.
    """
    tasks = as_task_set(tasks)
    if any(t.release_jitter for t in tasks):
        raise ValueError("fleet simulator requires release_jitter == 0")
    if policy == "rr" and len(tasks) > 1 and horizon >= P.RR_TASK_W:
        # the rr task-rotation rank outweighs releases only below this
        # horizon (repro.core.policy.RR_TASK_W); beyond it the rotation
        # would silently lose to release order
        raise ValueError(
            f"rr task rotation requires horizon < {P.RR_TASK_W:g} s "
            f"(got {horizon}); releases must stay below the rotation weight")
    n_units = np.array([len(t.unit_time) for t in tasks], np.int32)
    u_max = int(n_units.max())
    j_max = max(len(t.profiles) for t in tasks)

    unit_time = np.stack([
        _pad_trailing(np.asarray(t.unit_time, _F32), (u_max,), (0,))
        for t in tasks])
    unit_energy = np.stack([
        _pad_trailing(np.asarray(t.unit_energy, _F32), (u_max,), (0,))
        for t in tasks])

    def profile_table(t: TaskSpec, field: str, dtype) -> np.ndarray:
        tab = np.stack([np.asarray(getattr(p, field), dtype)
                        for p in t.profiles])
        return _pad_trailing(tab, (j_max, u_max), (1,))

    margins = np.stack([profile_table(t, "margins", _F32) for t in tasks])
    passes = np.stack([profile_table(t, "passes", bool) for t in tasks])
    correct = np.stack([profile_table(t, "correct", bool) for t in tasks])

    if exit_thresholds is None:
        exit_thr = np.zeros((len(tasks), u_max), _F32)
    else:
        exit_thr = np.asarray(exit_thresholds, _F32)
        if exit_thr.ndim == 1:
            exit_thr = np.broadcast_to(
                _pad_trailing(exit_thr, (u_max,), (0,)),
                (len(tasks), u_max)).copy()
        else:
            exit_thr = _pad_trailing(exit_thr, (len(tasks), u_max), (1,))

    # scalar-path normalisation: alpha from the *longest* relative deadline
    # in the set, the fragment-energy floor from the most expensive fragment
    max_frag_e = max(float(np.max(np.asarray(t.unit_energy)))
                     / t.fragments_per_unit for t in tasks)
    debt = 0.5 * cap.capacitance_f * cap.v_min ** 2
    return dict(
        policy=np.int32(P.POLICY_IDS[policy]),
        imprecise=np.bool_(policy in P.IMPRECISE_POLICIES),
        is_edfm=np.bool_(policy == "edf-m"),
        eta=_F32(eta),
        alpha=_F32(1.0 / max(t.deadline for t in tasks)),
        beta=_F32(1.0),
        persistent=np.bool_(eta >= 1.0 and harvester.p_stay_on >= 1.0),
        capacity=_F32(cap.capacity_j),
        start_energy=_F32(cap.capacity_j if start_charged else -debt),
        e_man=_F32(max_frag_e if e_man is None else e_man),
        e_opt=_F32(e_opt_fraction * cap.capacity_j),
        clock_drift=_F32(clock_drift),
        use_exit_thr=np.bool_(exit_thresholds is not None),
        exit_thr=exit_thr,
        power_on=_F32(harvester.power_on),
        period=np.array([t.period for t in tasks], _F32),
        rel_deadline=np.array([t.deadline for t in tasks], _F32),
        fragments=np.array([t.fragments_per_unit for t in tasks], _F32),
        n_units=n_units,
        n_releases=np.array([_n_releases(t, horizon) for t in tasks],
                            np.int32),
        unit_time=unit_time,
        unit_energy=unit_energy,
        margins=margins,
        passes=passes,
        correct=correct,
        events=np.asarray(events, _F32),
    )


def sample_events(harvester: Harvester, horizon: float, seed: int) -> np.ndarray:
    """Harvester ON/OFF slots exactly as the scalar ``simulate()`` draws them
    (fresh ``default_rng(seed)``, ``init=1``) — seed-matched parity hinges on
    reproducing this stream bit-for-bit."""
    n_slots = int(horizon / harvester.slot_s) + 2
    rng = np.random.default_rng(seed)
    return harvester.sample_events(rng, n_slots, init=1).astype(_F32)


def stack_configs(devices: Sequence[dict], device="cuda") -> FleetConfig:
    """Stack per-device dicts into a FleetConfig of ``(D, ...)`` tensors on
    ``device`` (dtypes as built: int32, bool, f32)."""
    return FleetConfig(**{
        f: torch.from_numpy(np.ascontiguousarray(
            np.stack([d[f] for d in devices]))).to(device)
        for f in FleetConfig._fields
    })


def from_sim_config(
    tasks: TaskSet,
    harvester: Harvester,
    eta: float,
    cap: Optional[Capacitor] = None,
    sim: Optional[SimConfig] = None,
    dt: Optional[float] = None,
    device="cuda",
) -> tuple[FleetConfig, FleetStatics]:
    """One-device FleetConfig mirroring the scalar simulator's setup for
    ``(tasks, harvester, eta, cap, sim)``; ``tasks`` may be one TaskSpec or
    a task set."""
    tasks = as_task_set(tasks)
    sim = sim or SimConfig()
    cap = cap or Capacitor()
    clock_drift = 0.0
    if type(sim.clock) is not Clock:
        if hasattr(sim.clock, "equivalent_drift"):
            # the scalar clock's random per-read error maps onto a
            # deterministic per-device drift rate
            clock_drift = sim.clock.equivalent_drift(sim.horizon)
        else:
            raise NotImplementedError(
                f"fleet path has no model for clock {type(sim.clock)}")
    # default dt = one fragment time: the scalar path's execution quantum
    dt = _check_dt(_default_dt(tasks) if dt is None else float(dt), tasks)
    statics = FleetStatics(queue_size=sim.queue_size, dt=dt,
                           horizon=sim.horizon, slot_s=harvester.slot_s)
    dev = device_config(
        tasks, harvester, eta, cap,
        policy=sim.policy, horizon=sim.horizon,
        events=sample_events(harvester, sim.horizon, sim.seed),
        e_opt_fraction=sim.e_opt_fraction, e_man=sim.e_man,
        start_charged=sim.start_charged, clock_drift=clock_drift,
    )
    return stack_configs([dev], device), statics


# --------------------------------------------------------------------------- #
# Sweep API.
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """Cartesian benchmark grid: one device per (policy, eta, harvester,
    capacitor, seed, clock drift) tuple, sharing one task-set workload
    (``task`` accepts one TaskSpec or a sequence)."""

    task: TaskSet
    policies: Sequence[str] = ("zygarde",)
    etas: Sequence[float] = (1.0,)
    harvesters: Sequence[Harvester] = ()
    capacitors: Sequence[Capacitor] = ()
    seeds: Sequence[int] = (0,)
    clock_drifts: Sequence[float] = (0.0,)   # fleet CHRT drift-rate axis
    horizon: float = 600.0
    dt: Optional[float] = None      # default: one fragment time
    queue_size: int = 3
    e_opt_fraction: float = 0.7
    e_man: Optional[float] = None
    start_charged: bool = False

    @property
    def tasks(self) -> tuple[TaskSpec, ...]:
        return as_task_set(self.task)

    def points(self):
        harvesters = self.harvesters or (PERSISTENT,)
        capacitors = self.capacitors or (Capacitor(),)
        for pol in self.policies:
            for eta in self.etas:
                for hi, h in enumerate(harvesters):
                    for cap in capacitors:
                        for seed in self.seeds:
                            for drift in self.clock_drifts:
                                yield dict(policy=pol, eta=eta, harvester=h,
                                           harvester_idx=hi, capacitor=cap,
                                           seed=seed, clock_drift=drift)


def build(grid: SweepGrid, device="cuda"
          ) -> tuple[FleetConfig, FleetStatics, list[dict]]:
    """Materialise the grid as a FleetConfig on ``device`` plus one
    metadata row per device."""
    points = list(grid.points())
    if not points:
        raise ValueError("empty sweep grid")
    tasks = grid.tasks
    slot_lens = {pt["harvester"].slot_s for pt in points}
    if len(slot_lens) != 1:
        raise ValueError("all harvesters in one sweep must share slot_s")
    dt = _check_dt(_default_dt(tasks) if grid.dt is None else grid.dt, tasks)
    statics = FleetStatics(queue_size=grid.queue_size, dt=dt,
                           horizon=grid.horizon, slot_s=slot_lens.pop())

    events_cache: dict[tuple[int, int], np.ndarray] = {}
    devices, meta = [], []
    for pt in points:
        key = (pt["harvester_idx"], pt["seed"])
        if key not in events_cache:
            events_cache[key] = sample_events(
                pt["harvester"], grid.horizon, pt["seed"])
        devices.append(device_config(
            tasks, pt["harvester"], pt["eta"], pt["capacitor"],
            policy=pt["policy"], horizon=grid.horizon,
            events=events_cache[key],
            e_opt_fraction=grid.e_opt_fraction, e_man=grid.e_man,
            start_charged=grid.start_charged,
            clock_drift=pt["clock_drift"],
        ))
        meta.append(dict(
            policy=pt["policy"], eta=pt["eta"],
            harvester=pt["harvester"].name, seed=pt["seed"],
            capacitance_f=pt["capacitor"].capacitance_f,
            clock_drift=pt["clock_drift"],
            n_tasks=len(tasks),
        ))
    return stack_configs(devices, device), statics, meta


def sweep(grid: SweepGrid, use_pallas=None, mesh=None, mode=None,
          device="cuda"):
    """Simulate the whole grid in one :func:`simulate_fleet` call.

    Returns ``(FleetResult, meta)``: the stacked ``(D,)`` metrics (plus the
    ``(D, K)`` per-task breakdowns) and the per-device metadata rows.
    ``mesh`` (e.g. :func:`repro_torch.launch.mesh.make_fleet_mesh`) cuts
    the device axis over its devices (:func:`simulate_fleet_sharded`): the
    results equal the call without a mesh bit for bit."""
    from .simulator import simulate_fleet_sharded

    cfg, statics, meta = build(grid, device)
    return simulate_fleet_sharded(cfg, statics, mesh=mesh,
                                  use_pallas=use_pallas, mode=mode), meta
