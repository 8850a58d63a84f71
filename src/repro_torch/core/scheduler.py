"""Imprecise real-time scheduler (paper §5) + discrete-event simulator.

Port of :mod:`repro.core.scheduler`: the workload and clock types that the
fleet grid builder and the serving engine consume, :class:`SimResult`, the
event-driven single-device simulator :func:`simulate` (a python loop over
numpy profiles, which launches nothing on the card) with its :class:`Job`
records and the Eq. 6/7 priorities :func:`zeta` / :func:`zeta_intermittent`,
and the fixed-step single-device frontend :func:`simulate_stepped` over the
step core.

The simulator executes *jobs* made of *units* (one DNN layer-group +
k-means classify + utility test each), themselves split into atomic
*fragments*.  Energy comes from a bursty harvester charging a capacitor; a
unit's fragments only run while the stored energy is above the fragment
cost, otherwise the CPU is off and time passes (a "reboot" when it comes
back).  Limited preemption: the scheduler runs at unit boundaries (paper
§4.1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .energy import Capacitor, Harvester
from .policy import IMPRECISE_POLICIES


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


@dataclass
class Job:
    task: TaskSpec
    job_id: int
    release: float
    deadline: float
    profile: JobProfile
    unit: int = 0                 # next unit to execute
    exited_at: int = -1           # unit index where the utility test passed
    last_pred_unit: int = -1      # deepest executed unit (prediction source)
    mandatory_done_time: float = -1.0
    finished: bool = False

    @property
    def n_units(self) -> int:
        return self.profile.n_units

    @property
    def mandatory_next(self) -> bool:
        """Is the *next* unit mandatory?  (gamma of Eq. 6/7)."""
        return self.exited_at < 0

    @property
    def utility(self) -> float:
        """Psi: confidence after the last executed unit (0 before any)."""
        if self.last_pred_unit < 0:
            return 0.0
        return float(self.profile.margins[self.last_pred_unit])

    @property
    def mandatory_met(self) -> bool:
        return self.mandatory_done_time >= 0

    @property
    def prediction_correct(self) -> Optional[bool]:
        if self.last_pred_unit < 0:
            return None
        return bool(self.profile.correct[self.last_pred_unit])


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


# Eqs. 6-7 on python floats (f64), in the reference's order of operations:
# the reference's scalar loop calls its array policy with python floats, so
# nothing there rounds to f32.  The port's tensor policy forms two terms as
# f32 FMAs (``core/_fma.py``), which would move picks at near ties.


def zeta(job: Job, t_now: float, alpha: float, beta: float) -> float:
    laxity = job.deadline - t_now
    gamma = 1.0 * job.mandatory_next
    return float((1.0 - alpha * laxity) + (1.0 - beta * job.utility) + gamma)


def zeta_intermittent(
    job: Job, t_now: float, alpha: float, beta: float,
    eta: float, e_curr: float, e_opt: float,
) -> float:
    laxity = job.deadline - t_now
    base = (1.0 - alpha * laxity) + (1.0 - beta * job.utility)
    gamma = 1.0 * job.mandatory_next
    gate = 1.0 * (eta * e_curr >= e_opt)
    return float(gate * (base + gamma) + (1.0 - gate) * gamma * base)


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


def simulate(
    tasks: Sequence[TaskSpec],
    harvester: Harvester,
    eta: float,
    cap: Optional[Capacitor] = None,
    sim: Optional[SimConfig] = None,
) -> SimResult:
    """The event-driven single-device scheduler loop.  Host code: draws from
    ``np.random.default_rng(sim.seed)`` in the reference's order (the
    harvester's events, one release jitter per job in task order, one clock
    read per queue sweep and per off-wait step), so every result equals the
    reference's bit for bit.  The mutated :class:`Job` records are exposed
    as ``res.jobs`` (a plain attribute: ``as_dict`` stays JSON-safe)."""
    sim = sim or SimConfig()
    cap = cap or Capacitor()
    cap = dataclasses.replace(cap) if dataclasses.is_dataclass(cap) else cap
    cap.energy_j = cap.capacity_j if sim.start_charged else 0.0
    rng = np.random.default_rng(sim.seed)
    res = SimResult(
        task_released=np.zeros(len(tasks), np.int64),
        task_scheduled=np.zeros(len(tasks), np.int64),
        task_correct=np.zeros(len(tasks), np.int64),
        task_misses=np.zeros(len(tasks), np.int64),
    )
    task_row = {t.task_id: i for i, t in enumerate(tasks)}

    max_frag_e = max(
        float(np.max(t.unit_energy)) / t.fragments_per_unit for t in tasks
    )
    e_man = sim.e_man if sim.e_man is not None else max_frag_e
    e_opt = sim.e_opt_fraction * cap.capacity_j
    max_deadline = max(t.deadline for t in tasks)
    alpha, beta = 1.0 / max_deadline, 1.0

    # --- energy slots ------------------------------------------------------ #
    n_slots = int(sim.horizon / harvester.slot_s) + 2
    events = harvester.sample_events(rng, n_slots, init=1)

    def power_at(t: float) -> float:
        slot = min(int(t / harvester.slot_s), n_slots - 1)
        return events[slot] * harvester.power_on

    # --- job releases ------------------------------------------------------ #
    releases: list[Job] = []
    for task in tasks:
        t, j = 0.0, 0
        while t < sim.horizon and j < len(task.profiles):
            rel = t + rng.uniform(0, task.release_jitter)
            releases.append(
                Job(task, j, rel, rel + task.deadline, task.profiles[j])
            )
            res.task_released[task_row[task.task_id]] += 1
            t += task.period
            j += 1
    releases.sort(key=lambda job: job.release)
    res.released = len(releases)

    queue: list[Job] = []
    rel_idx = 0
    t_now = 0.0
    was_off = False
    rr_cursor = 0

    def admit(t_now: float):
        nonlocal rel_idx
        while rel_idx < len(releases) and releases[rel_idx].release <= t_now:
            if len(queue) >= sim.queue_size:
                # a job whose mandatory part is done only holds optional
                # work: evict it in favour of the new arrival (mandatory
                # first, paper §5.2)
                evictable = [j for j in queue if j.exited_at >= 0]
                if evictable:
                    victim = min(evictable, key=lambda j: j.deadline)
                    queue.remove(victim)
                    finish_job(victim)
            if len(queue) < sim.queue_size:
                queue.append(releases[rel_idx])
            else:
                res.deadline_misses += 1  # queue overflow = dropped
                res.task_misses[task_row[releases[rel_idx].task.task_id]] += 1
            rel_idx += 1

    def drop_expired(t_now: float):
        t_read = sim.clock.read(t_now, rng)
        for job in list(queue):
            if t_read >= job.deadline:
                queue.remove(job)
                finish_job(job)

    def finish_job(job: Job):
        job.finished = True
        k = task_row[job.task.task_id]
        if job.mandatory_met and job.mandatory_done_time <= job.deadline:
            res.scheduled += 1
            res.task_scheduled[k] += 1
            if job.prediction_correct:
                res.correct += 1
                res.task_correct[k] += 1
        else:
            res.deadline_misses += 1
            res.task_misses[k] += 1

    def pick(t_now: float) -> Optional[Job]:
        nonlocal rr_cursor
        if not queue:
            return None
        cands = queue
        # exact lexicographic ordering for EDF / EDF-M / RR
        if sim.policy == "edf":
            return min(cands, key=lambda j: (j.deadline, j.release))
        if sim.policy == "edf-m":
            mand = [j for j in cands if j.mandatory_next]
            return (
                min(mand, key=lambda j: (j.deadline, j.release)) if mand else None
            )
        if sim.policy == "rr":
            by_task = sorted({j.task.task_id for j in cands})
            for off in range(len(by_task)):
                tid = by_task[(rr_cursor + off) % len(by_task)]
                sub = [j for j in cands if j.task.task_id == tid]
                if sub:
                    rr_cursor = (rr_cursor + off + 1) % len(by_task)
                    return min(sub, key=lambda j: j.release)
            return None
        # zygarde
        if eta >= 1.0 and harvester.p_stay_on >= 1.0:
            key = lambda j: zeta(j, t_now, alpha, beta)  # noqa: E731
        else:
            key = lambda j: zeta_intermittent(  # noqa: E731
                j, t_now, alpha, beta, eta, cap.energy_j, e_opt
            )
        best = max(queue, key=key)
        if key(best) <= 0.0:
            return None  # only optional work and energy gate closed
        return best

    # --- cold boot ---------------------------------------------------------- #
    # Charging from 0 V to the MCU cutoff v_min stores 1/2 C v_min^2 of
    # unusable "dead-zone" energy first (paper Fig. 21).
    if not sim.start_charged:
        debt = 0.5 * cap.capacitance_f * cap.v_min ** 2
        while debt > 0.0 and t_now < sim.horizon:
            debt -= power_at(t_now) * sim.dt
            t_now += sim.dt
            res.idle_no_energy += sim.dt

    # --- main loop ---------------------------------------------------------- #
    while t_now < sim.horizon:
        admit(t_now)
        drop_expired(t_now)
        job = pick(t_now)
        if job is None:
            if rel_idx >= len(releases) and not queue:
                break
            cap.charge(power_at(t_now) * sim.dt)
            t_now += sim.dt
            continue

        # execute one unit = fragments_per_unit atomic fragments
        u = job.unit
        frag_t = job.task.unit_time[u] / job.task.fragments_per_unit
        frag_e = job.task.unit_energy[u] / job.task.fragments_per_unit
        frag = 0
        aborted = False
        while frag < job.task.fragments_per_unit:
            if cap.energy_j < max(frag_e, e_man):
                # power down: wait for charge
                was_off = True
                res.idle_no_energy += sim.dt
                cap.charge(power_at(t_now) * sim.dt)
                t_now += sim.dt
                if t_now >= sim.horizon:
                    aborted = True
                    break
                if sim.clock.read(t_now, rng) >= job.deadline:
                    aborted = True
                    break
                continue
            if was_off:
                # the initial cold boot is not a reboot
                if res.busy_time > 0:
                    res.reboots += 1
                # re-execute the interrupted fragment (the partial work was
                # lost)
                res.wasted_reexec += frag_t * 0.5
                was_off = False
            cap.charge(power_at(t_now) * frag_t)
            cap.discharge(frag_e)
            t_now += frag_t
            res.busy_time += frag_t
            frag += 1

        if aborted:
            continue  # deadline/horizon handling at loop top

        # unit complete: classify + utility test (costs folded into unit_time)
        res.units_executed += 1
        if not job.mandatory_next:
            res.optional_units += 1
        job.last_pred_unit = u
        job.unit += 1
        imprecise = sim.policy in IMPRECISE_POLICIES
        if imprecise and job.exited_at < 0 and job.profile.passes[u]:
            job.exited_at = u
            job.mandatory_done_time = t_now
        if job.exited_at < 0 and job.unit >= job.n_units:
            # imprecise: never-confident => full execution is mandatory.
            # EDF/RR (no early termination): the whole DNN is mandatory.
            job.exited_at = job.n_units - 1
            job.mandatory_done_time = t_now

        job_done = job.unit >= job.n_units
        if imprecise and job.exited_at >= 0 and sim.policy == "edf-m":
            job_done = True  # EDF-M never runs optional units
        if job_done:
            queue.remove(job)
            finish_job(job)

    # flush remaining jobs
    for job in queue:
        finish_job(job)
    while rel_idx < len(releases):
        res.deadline_misses += 1
        res.task_misses[task_row[releases[rel_idx].task.task_id]] += 1
        rel_idx += 1
    res.sim_time = t_now
    # the mutated Job records, as a plain attribute (not a dataclass field)
    res.jobs = releases
    return res
