"""The unified per-device step core: ONE implementation of the scheduler
transition (port of :mod:`repro.core.step`).

Everything that happens to an intermittently-powered device in one fixed
timestep — release/admit, expiry, priority pick via
:mod:`repro_torch.core.policy`, fragment execution, capacitor
charge/discharge, metric accumulation — lives here as pure functions over
two NamedTuples of tensors:

* :class:`StepParams` — immutable per-device configuration (task tables,
  harvester event stream, scheduler scalars).
* :class:`DeviceCarry` — the mutable state threaded through
  ``(params, carry, t) -> carry`` transitions.

Every function is batch-polymorphic: any leading axes (the fleet's device
axis) ride along on every leaf, so a fleet is one call, not a ``vmap``.
Table lookups are :func:`torch.gather` with clamped indices; every call
site whose index can be out of range masks the looked-up value downstream,
as the reference does.

Numerics (held bit for bit against the reference as XLA compiles it on
the CPU):

* each product and sum is its own f32 rounding, except the multiply-adds
  the compiled reference contracts into one rounding: the capacitor charge
  ``energy + power * dt`` (:func:`select_and_charge`) and the priority
  terms of :mod:`repro_torch.core.policy`, formed with
  :func:`repro_torch.core._fma.fma_f32`;
* a python scalar never sits on the left of a division (PyTorch turns
  ``s / x`` into ``s * (1 / x)``): the constant becomes an f32 tensor;
* ``jnp.mod`` is floor-mod (:func:`torch.remainder`), every arg-min/max
  takes the first index, and ``(t / slot_s)`` truncates toward zero.

Shapes use ``K`` tasks per device, ``Q`` queue slots, ``U`` units per job,
``J`` jobs per task, ``S`` harvester slots.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import policy as P
from ._fma import fma_f32

_F32 = torch.float32
_I32 = torch.int32


# --------------------------------------------------------------------------- #
# Batched indexing helpers.
# --------------------------------------------------------------------------- #


def _bshape(a, b) -> tuple:
    """Broadcast two shapes (numpy rules; callers pass compatible ones)."""
    n = max(len(a), len(b))
    a = (1,) * (n - len(a)) + tuple(a)
    b = (1,) * (n - len(b)) + tuple(b)
    return tuple(y if x == 1 else x for x, y in zip(a, b))


def _take(table, idx):
    """``table[..., idx]`` over the trailing axis with clamped indices.

    ``table``: ``(..., N)``; ``idx``: int ``(..., Q)`` whose leading axes
    broadcast against the table's -> ``(..., Q)`` in ``table.dtype``.
    """
    lead = _bshape(table.shape[:-1], idx.shape[:-1])
    n = table.shape[-1]
    ix = idx.clamp(0, n - 1).to(torch.int64)
    return torch.gather(table.expand(lead + table.shape[-1:]), -1,
                        ix.expand(lead + idx.shape[-1:]))


def _take1(table, idx):
    """``table[..., idx]`` for a single per-device index."""
    return _take(table, idx[..., None])[..., 0]


def take_rows(table, idx):
    """``table[..., idx, :]`` — one row of the second-to-last axis per index
    (clamped).  ``table``: ``(..., N, M)``; ``idx``: int ``(...,)``."""
    n, m = table.shape[-2], table.shape[-1]
    lead = _bshape(table.shape[:-2], idx.shape)
    ix = idx.clamp(0, n - 1).to(torch.int64)[..., None, None]
    return torch.gather(table.expand(lead + (n, m)), -2,
                        ix.expand(lead + (1, m)))[..., 0, :]


def _oh_eq(idx, n: int):
    """One-hot of ``idx`` over a new trailing axis of size ``n`` (bool)."""
    return idx[..., None] == torch.arange(n, device=idx.device,
                                          dtype=idx.dtype)


def _flat2(t):
    """Collapse the two trailing axes (e.g. (..., K, U) -> (..., K*U))."""
    return t.reshape(t.shape[:-2] + (t.shape[-2] * t.shape[-1],))


def _flat3(t):
    """Collapse the three trailing axes ((..., K, J, U) -> (..., K*J*U))."""
    return t.reshape(
        t.shape[:-3] + (t.shape[-3] * t.shape[-2] * t.shape[-1],))


def _put(mask, value, old):
    """``torch.where(mask, value, old)`` in ``old``'s dtype (a python
    scalar takes the tensor's dtype, so no promotion can creep in)."""
    if isinstance(value, torch.Tensor):
        value = value.to(old.dtype)
    return torch.where(mask, value, old)


def f32_const(x: float, device) -> torch.Tensor:
    """A python double rounded once to an f32 0-d tensor (``np.float32``
    semantics), for constants that must divide or be compared exactly."""
    return torch.full((), float(np.float32(x)), dtype=_F32, device=device)


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Hashable static configuration."""

    queue_size: int = 3
    dt: float = 0.025            # fixed timestep (s); keep <= min unit_time
    horizon: float = 600.0
    slot_s: float = 1.0          # harvester slot length (s)

    @property
    def n_steps(self) -> int:
        return int(round(self.horizon / self.dt))

    @property
    def dt_eps(self) -> float:
        """The unit-completion tolerance ``dt * 1e-3``: a python-double
        product rounded once to f32, as the reference computes it."""
        return float(np.float32(self.dt * 1e-3))


class StepParams(NamedTuple):
    """Immutable per-device configuration tensors (fleet: leading ``D``)."""

    policy: torch.Tensor        # int32, POLICY_IDS
    imprecise: torch.Tensor     # bool: early exit enabled (zygarde, edf-m)
    is_edfm: torch.Tensor       # bool: EDF-M never runs optional units
    eta: torch.Tensor           # f32
    alpha: torch.Tensor         # f32, 1 / max relative deadline
    beta: torch.Tensor          # f32
    persistent: torch.Tensor    # bool: zeta (Eq. 6) instead of zeta_I (Eq. 7)
    capacity: torch.Tensor      # f32, usable capacitor energy (J)
    start_energy: torch.Tensor  # f32; negative = cold-boot dead-zone debt
    e_man: torch.Tensor         # f32, minimum energy to run a fragment
    e_opt: torch.Tensor         # f32, Eq. 7 optional-unit energy threshold
    power_on: torch.Tensor      # f32, harvester power in the ON state (W)
    clock_drift: torch.Tensor   # f32; t_read = t * (1 + clock_drift)
    use_exit_thr: torch.Tensor  # bool: live margin vs exit_thr
    exit_thr: torch.Tensor      # (K, U) f32
    period: torch.Tensor        # (K,) f32
    rel_deadline: torch.Tensor  # (K,) f32
    fragments: torch.Tensor     # (K,) f32, fragments per unit
    n_units: torch.Tensor       # (K,) int32
    n_releases: torch.Tensor    # (K,) int32
    unit_time: torch.Tensor     # (K, U) f32
    unit_energy: torch.Tensor   # (K, U) f32
    margins: torch.Tensor       # (K, J, U) f32
    passes: torch.Tensor        # (K, J, U) bool
    correct: torch.Tensor       # (K, J, U) bool
    events: torch.Tensor        # (S,) f32 harvester event stream

    @property
    def n_devices(self) -> int:
        """Fleet-level accessor (leading device axis stacked on every leaf)."""
        return self.policy.shape[0]


class DeviceCarry(NamedTuple):
    """Mutable per-device simulation state (fleet: leading ``D``)."""

    energy: torch.Tensor        # f32; < 0 while paying cold-boot debt
    was_off: torch.Tensor       # bool: last activity was a power-down
    next_rel: torch.Tensor      # (K,) int32: next job index to release
    rr_cursor: torch.Tensor     # int32: task id the rr policy serves next
    lock_slot: torch.Tensor     # int32: queue slot mid-unit, -1 if none
    lock_job: torch.Tensor      # int32: job id the lock belongs to
    q_active: torch.Tensor      # (Q,) bool
    q_release: torch.Tensor     # (Q,) f32
    q_deadline: torch.Tensor    # (Q,) f32 (absolute)
    q_task: torch.Tensor        # (Q,) int32
    q_job: torch.Tensor         # (Q,) int32
    q_unit: torch.Tensor        # (Q,) int32, next unit to execute
    q_time_left: torch.Tensor   # (Q,) f32, seconds left in the unit
    q_exited: torch.Tensor      # (Q,) int32, unit where the test passed
    q_last_pred: torch.Tensor   # (Q,) int32, deepest executed unit
    q_mand_time: torch.Tensor   # (Q,) f32, mandatory-completion time
    q_margin: torch.Tensor      # (Q,) f32, live margin (serving)
    q_correct: torch.Tensor     # (Q,) bool, live correctness (serving)
    q_apass: torch.Tensor       # (Q,) bool, utility test passed once
    m_scheduled: torch.Tensor   # (K,) int32
    m_correct: torch.Tensor     # (K,) int32
    m_misses: torch.Tensor      # (K,) int32
    m_units: torch.Tensor       # (K,) int32
    m_optional: torch.Tensor    # (K,) int32
    m_reboots: torch.Tensor     # int32
    m_busy: torch.Tensor        # f32
    m_idle: torch.Tensor        # f32
    m_wasted: torch.Tensor      # f32


class StepResult(NamedTuple):
    """Finalized metrics — aggregates ``(D,)`` and per-task ``(D, K)``."""

    released: torch.Tensor
    scheduled: torch.Tensor
    correct: torch.Tensor
    deadline_misses: torch.Tensor
    units_executed: torch.Tensor
    optional_units: torch.Tensor
    busy_time: torch.Tensor
    idle_no_energy: torch.Tensor
    reboots: torch.Tensor
    wasted_reexec: torch.Tensor
    sim_time: torch.Tensor
    task_released: torch.Tensor
    task_scheduled: torch.Tensor
    task_correct: torch.Tensor
    task_misses: torch.Tensor
    task_units: torch.Tensor
    task_optional: torch.Tensor

    def device(self, i: int) -> dict:
        """Metrics of device ``i`` as a python dict."""
        out = {}
        for k, v in self._asdict().items():
            row = v[i]
            out[k] = row.item() if row.ndim == 0 else row.tolist()
        return out


def init_carry(params: StepParams, statics: StepStatics) -> DeviceCarry:
    """Initial carry for every device of ``params`` (leading axes kept)."""
    q = statics.queue_size
    lead = tuple(params.policy.shape)
    k = params.period.shape[-1]
    dev = params.policy.device

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    return DeviceCarry(
        energy=params.start_energy.to(_F32).clone(),
        was_off=full((), False, torch.bool),
        next_rel=full((k,), 0, _I32),
        rr_cursor=full((), 0, _I32),
        lock_slot=full((), -1, _I32),
        lock_job=full((), -1, _I32),
        q_active=full((q,), False, torch.bool),
        q_release=full((q,), 0.0, _F32),
        q_deadline=full((q,), 0.0, _F32),
        q_task=full((q,), 0, _I32),
        q_job=full((q,), 0, _I32),
        q_unit=full((q,), 0, _I32),
        q_time_left=full((q,), 0.0, _F32),
        q_exited=full((q,), -1, _I32),
        q_last_pred=full((q,), -1, _I32),
        q_mand_time=full((q,), -1.0, _F32),
        q_margin=full((q,), 0.0, _F32),
        q_correct=full((q,), False, torch.bool),
        q_apass=full((q,), False, torch.bool),
        m_scheduled=full((k,), 0, _I32),
        m_correct=full((k,), 0, _I32),
        m_misses=full((k,), 0, _I32),
        m_units=full((k,), 0, _I32),
        m_optional=full((k,), 0, _I32),
        m_reboots=full((), 0, _I32),
        m_busy=full((), 0.0, _F32),
        m_idle=full((), 0.0, _F32),
        m_wasted=full((), 0.0, _F32),
    )


# --------------------------------------------------------------------------- #
# Transition stages.
# --------------------------------------------------------------------------- #


def finish_counts(params: StepParams, st: DeviceCarry, mask,
                  live: bool = False):
    """Tally (scheduled, correct, missed) for the queue slots in ``mask``,
    per task — ``(..., K)`` int32 each.  ``live`` reads the slot's live
    correctness register instead of the replay table."""
    n_tasks = params.period.shape[-1]
    tk = st.q_task.clamp(0, n_tasks - 1)
    sched = mask & (st.q_mand_time >= 0.0) & (st.q_mand_time <= st.q_deadline)
    if live:
        corr = sched & (st.q_last_pred >= 0) & st.q_correct
    else:
        n_jobs = params.margins.shape[-2]
        n_u = params.margins.shape[-1]
        job = st.q_job.clamp(0, n_jobs - 1)
        lp = st.q_last_pred.clamp(0, n_u - 1)
        corr = sched & (st.q_last_pred >= 0) & _take(
            _flat3(params.correct), (tk * n_jobs + job) * n_u + lp)
    miss = mask & ~sched
    onehot = _oh_eq(tk, n_tasks)                           # (..., Q, K)

    def per_task(m):
        return (m[..., None] & onehot).sum(-2, dtype=_I32)

    return per_task(sched), per_task(corr), per_task(miss)


class StepTrace(NamedTuple):
    """Per-step event descriptors of a transition (telemetry's in-loop
    emission; :mod:`repro_torch.telemetry.trace` decodes them).  Leading
    device axes as on the carry.

    Every retirement flows through one of three channels, at most one event
    per task each (one release per task per step; same-task deadlines are
    a period apart), so ``(..., K)`` words capture a step losslessly.
    Words (0 = no event): ``exited + 2`` in bits 0-5, the task id in bits
    6-10 where present, ``job + 1`` above.  The ``*_dl`` floats carry the
    retiring slot's deadline register; garbage where the word is 0.
    """

    adm: torch.Tensor        # (..., K) i32: insert | dropped << 1 | evict << 2
    evict: torch.Tensor      # (..., K) i32: (job+1)<<11 | task<<6 | exited+2
    evict_dl: torch.Tensor   # (..., K) f32: victim q_deadline
    expire: torch.Tensor     # (..., K) i32: (job+1)<<6 | exited+2
    expire_dl: torch.Tensor  # (..., K) f32: expired-slot q_deadline
    complete: torch.Tensor   # (...,) i32: (job+1)<<11 | task<<6 | exited+2
    complete_dl: torch.Tensor  # (...,) f32: completed slot q_deadline


def admit(params: StepParams, st: DeviceCarry, t, statics: StepStatics,
          live: bool = False, trace: bool = False):
    """Admit at most one released job per task, in task order; on a full
    queue evict the earliest-deadline job whose mandatory part is done.

    ``trace`` additionally returns the ``(adm, evict, evict_dl)`` words of
    :class:`StepTrace`, read from values the stage already computed; the
    plain path's ops are unchanged."""
    q = statics.queue_size
    n_tasks = params.period.shape[-1]
    k_iota = torch.arange(n_tasks, device=st.next_rel.device, dtype=_I32)
    inf = torch.full((), float("inf"), dtype=_F32, device=t.device)
    tr_adm, tr_evict, tr_evict_dl = [], [], []
    for k in range(n_tasks):
        nr_k = st.next_rel[..., k]
        rel_time = nr_k.to(_F32) * params.period[..., k]
        releasing = (nr_k < params.n_releases[..., k]) & (rel_time <= t)

        free = ~st.q_active
        has_free = free.any(-1)
        evictable = st.q_active & (st.q_exited >= 0)
        has_evict = evictable.any(-1)
        victim = torch.argmin(torch.where(evictable, st.q_deadline, inf),
                              dim=-1).to(_I32)
        evict = releasing & ~has_free & has_evict
        vmask = evict[..., None] & _oh_eq(victim, q)
        d_sched, d_corr, d_miss = finish_counts(params, st, vmask, live)

        insert = releasing & (has_free | has_evict)
        slot = torch.where(has_free,
                           torch.argmax(free.to(_I32), dim=-1).to(_I32),
                           victim)
        ins = insert[..., None] & _oh_eq(slot, q)
        dropped = releasing & ~insert
        k_hot = k_iota == k

        if trace:
            # the victim's pre-step registers (a job admitted this step
            # has q_exited == -1 and is never evictable)
            tr_adm.append(insert.to(_I32) + (dropped.to(_I32) << 1)
                          + (evict.to(_I32) << 2))
            tr_evict.append(torch.where(
                evict, ((_take1(st.q_job, victim) + 1) << 11)
                + (_take1(st.q_task, victim) << 6)
                + (_take1(st.q_exited, victim) + 2), 0).to(_I32))
            tr_evict_dl.append(_take1(st.q_deadline, victim))

        st = st._replace(
            next_rel=st.next_rel + (k_hot & releasing[..., None]).to(_I32),
            q_active=(st.q_active & ~vmask) | ins,
            q_release=_put(ins, rel_time[..., None], st.q_release),
            q_deadline=_put(
                ins, (rel_time + params.rel_deadline[..., k])[..., None],
                st.q_deadline),
            q_task=_put(ins, k, st.q_task),
            q_job=_put(ins, nr_k[..., None], st.q_job),
            q_unit=_put(ins, 0, st.q_unit),
            q_time_left=_put(ins, params.unit_time[..., k, 0][..., None],
                             st.q_time_left),
            q_exited=_put(ins, -1, st.q_exited),
            q_last_pred=_put(ins, -1, st.q_last_pred),
            q_mand_time=_put(ins, -1.0, st.q_mand_time),
            q_margin=_put(ins, 0.0, st.q_margin),
            q_correct=_put(ins, False, st.q_correct),
            q_apass=_put(ins, False, st.q_apass),
            m_scheduled=st.m_scheduled + d_sched,
            m_correct=st.m_correct + d_corr,
            m_misses=(st.m_misses + d_miss
                      + (dropped[..., None] & k_hot).to(_I32)),
        )
    if trace:
        return st, (torch.stack(tr_adm, -1), torch.stack(tr_evict, -1),
                    torch.stack(tr_evict_dl, -1))
    return st


def drop_expired(params: StepParams, st: DeviceCarry, t,
                 live: bool = False, trace: bool = False,
                 q_active_pre=None):
    """Expire queued jobs against the device's drifting clock.

    ``trace`` additionally returns the ``(expire, expire_dl)`` words of
    :class:`StepTrace`; ``q_active_pre`` (the queue before this step's
    admissions) leaves out jobs admitted this very step, which the
    carry-delta view (:func:`step_events`) never counts as retirements."""
    t_read = t * (1.0 + params.clock_drift)
    expired = st.q_active & (t_read[..., None] >= st.q_deadline)
    d_sched, d_corr, d_miss = finish_counts(params, st, expired, live)
    new = st._replace(
        q_active=st.q_active & ~expired,
        m_scheduled=st.m_scheduled + d_sched,
        m_correct=st.m_correct + d_corr,
        m_misses=st.m_misses + d_miss,
    )
    if not trace:
        return new
    # at most one same-task deadline crosses per dt, so one word per task
    n_tasks = params.period.shape[-1]
    exp = expired if q_active_pre is None else expired & q_active_pre
    word = ((st.q_job + 1) << 6) + (st.q_exited + 2)
    onehot = exp[..., None] & (st.q_task[..., None] == torch.arange(
        n_tasks, device=exp.device, dtype=_I32))             # (..., Q, K)
    tr_exp = torch.where(onehot, word[..., None], 0).sum(-2, dtype=_I32)
    tr_exp_dl = torch.where(onehot, st.q_deadline[..., None],
                            torch.zeros((), dtype=_F32,
                                        device=exp.device)).sum(-2)
    return new, (tr_exp, tr_exp_dl)


def pick_inputs(params: StepParams, st: DeviceCarry, t,
                statics: StepStatics, live: bool = False):
    """Per-slot priority/energy ingredients: each slot gathers its own
    task's row of the (K, U) / (K, J, U) tables.  ``live`` swaps the
    replayed utility margin for the slot's live margin register."""
    n_tasks = params.period.shape[-1]
    n_u = params.unit_time.shape[-1]
    tk = st.q_task.clamp(0, n_tasks - 1)
    u = st.q_unit.clamp(0, n_u - 1)
    unit_t = _take(_flat2(params.unit_time), tk * n_u + u)
    unit_e = _take(_flat2(params.unit_energy), tk * n_u + u)
    gate_e = torch.maximum(unit_e / _take(params.fragments, tk),
                           params.e_man[..., None])
    drain = unit_e * (f32_const(statics.dt, unit_t.device) / unit_t)
    if live:
        margin = st.q_margin
    else:
        n_jobs = params.margins.shape[-2]
        job = st.q_job.clamp(0, n_jobs - 1)
        lp = st.q_last_pred.clamp(0, params.margins.shape[-1] - 1)
        margin = _take(_flat3(params.margins),
                       (tk * n_jobs + job) * params.margins.shape[-1] + lp)
    utility = torch.where(st.q_last_pred >= 0, margin,
                          torch.zeros_like(margin))
    mandatory = st.q_exited < 0
    laxity = st.q_deadline - t
    n_slots = params.events.shape[-1]
    slot = torch.clamp((t / statics.slot_s).to(_I32), max=n_slots - 1)
    # harvested power this slot; the charge power * dt is formed inside the
    # capacitor update (select_and_charge), fused with its add
    power = _take1(params.events, slot) * params.power_on
    # limited preemption: a slot mid-unit is forced until the unit boundary
    # (unless it expired or its slot was recycled for a newer job)
    ls = st.lock_slot.clamp(0, st.q_active.shape[-1] - 1)
    locked = ((st.lock_slot >= 0) & _take1(st.q_active, ls)
              & (_take1(st.q_job, ls) == st.lock_job))
    forced = torch.where(locked, ls, torch.full_like(ls, -1))
    # rr task rotation: distance of each slot's task from the rr cursor
    task_rank = torch.remainder(tk - st.rr_cursor[..., None],
                                n_tasks).to(_F32)
    return (laxity, utility, mandatory, gate_e, drain, power, forced,
            task_rank)


def select_and_charge(scores, threshold, forced, energy, power, capacity,
                      gate_e, drain, dt: float):
    """Post-score selection + fused capacitor update (reduces over the
    trailing queue axis; leading axes batch).  The charge ``energy + power
    * dt`` is one rounding, as the compiled reference forms it."""
    sel = torch.where(forced >= 0, forced,
                      torch.argmax(scores, dim=-1).to(_I32))
    picked = (forced >= 0) | (scores.amax(dim=-1) > threshold)
    gate_sel = _take1(gate_e, sel)
    drain_sel = _take1(drain, sel)
    run = picked & (energy >= gate_sel)
    e_new = (torch.minimum(fma_f32(power, dt, energy), capacity)
             - run.to(_F32) * drain_sel)
    return sel, picked, run, e_new


def pick(params: StepParams, st: DeviceCarry, t, statics: StepStatics,
         live: bool = False):
    """Priority-argmax + fused capacitor charge/discharge."""
    (laxity, utility, mandatory, gate_e, drain, power, forced,
     task_rank) = pick_inputs(params, st, t, statics, live)
    scores, thr = P.policy_scores(
        params.policy[..., None], st.q_active, laxity, st.q_release,
        utility, mandatory, params.alpha[..., None], params.beta[..., None],
        params.eta[..., None], st.energy[..., None], params.e_opt[..., None],
        params.persistent[..., None], task_rank)
    return select_and_charge(scores, thr[..., 0], forced, st.energy, power,
                             params.capacity, gate_e, drain, statics.dt)


def apply_step(params: StepParams, st: DeviceCarry, t, sel, picked, run,
               e_new, statics: StepStatics, live: bool = False,
               outcomes=None, t_end=None, trace: bool = False,
               q_active_pre=None):
    """Advance the selected job by dt; handle unit/job completion.

    ``t_end`` defaults to ``t + dt`` (two f32 roundings: ``t = i * dt``
    first, then the sum).  ``live``/``outcomes``: a ``(margin, passed,
    correct)`` triple for the selected slot's just-completing unit, with
    the leading device axes but not the queue axis; it replaces every read
    of the ``margins``/``passes``/``correct`` replay tables.  ``trace``
    additionally returns the ``(complete, complete_dl)`` words of
    :class:`StepTrace` (``q_active_pre`` as in :func:`drop_expired`).
    """
    q = statics.queue_size
    n_tasks = params.period.shape[-1]
    n_u = params.unit_time.shape[-1]
    u_max = n_u - 1
    dt = statics.dt
    oh = _oh_eq(sel, q)
    tk = st.q_task.clamp(0, n_tasks - 1)
    tk_sel = _take1(tk, sel)

    u_sel = _take1(st.q_unit, sel).clamp(0, u_max)
    frag_t = (_take1(_flat2(params.unit_time), tk_sel * n_u + u_sel)
              / _take1(params.fragments, tk_sel))

    reboot = run & st.was_off
    was_off = torch.where(run, torch.zeros_like(run),
                          torch.where(picked, torch.ones_like(run),
                                      st.was_off))
    zero = torch.zeros((), dtype=_F32, device=sel.device)
    dt_t = torch.full((), dt, dtype=_F32, device=sel.device)
    idle_inc = torch.where(picked & ~run, dt_t, zero)

    time_left = st.q_time_left - torch.where(run[..., None] & oh, dt_t, zero)
    complete = run[..., None] & oh & (time_left <= statics.dt_eps)

    u = st.q_unit.clamp(0, u_max)
    job = st.q_job.clamp(0, params.passes.shape[-2] - 1)
    n_units = _take(params.n_units, tk)        # (..., Q) per-slot task depth
    next_u = (st.q_unit + 1).clamp(0, u_max)
    done_any = complete.any(-1)
    mandatory = st.q_exited < 0

    last_pred = torch.where(complete, u, st.q_last_pred)
    unit = torch.where(complete, st.q_unit + 1, st.q_unit)
    time_left = torch.where(
        complete, _take(_flat2(params.unit_time), tk * n_u + next_u),
        time_left)

    if live:
        margin_sel, passed_sel, correct_sel = outcomes
        passed = passed_sel[..., None].expand(complete.shape)
        q_margin = torch.where(complete, margin_sel[..., None], st.q_margin)
        q_correct = torch.where(complete, correct_sel[..., None],
                                st.q_correct)
        st = st._replace(q_margin=q_margin, q_correct=q_correct)
    else:
        n_jobs = params.margins.shape[-2]
        kju = (tk * n_jobs + job) * n_u + u
        passed = torch.where(
            params.use_exit_thr[..., None],
            P.exit_test(_take(_flat3(params.margins), kju),
                        _take(_flat2(params.exit_thr), tk * n_u + u)),
            _take(_flat3(params.passes), kju))
    exit_now = (complete & params.imprecise[..., None]
                & (st.q_exited < 0) & passed)
    exited = torch.where(exit_now, u, st.q_exited)
    # never-confident full execution => the whole DNN was mandatory
    full_mand = complete & (exited < 0) & (st.q_unit + 1 >= n_units)
    exited = torch.where(full_mand, n_units - 1, exited)
    if t_end is None:
        t_end = t + dt
    mand_time = torch.where(exit_now | full_mand, t_end, st.q_mand_time)

    job_done = complete & (
        (st.q_unit + 1 >= n_units)
        | (params.is_edfm[..., None] & (exited >= 0))
    )
    st_done = st._replace(q_last_pred=last_pred, q_mand_time=mand_time)
    d_sched, d_corr, d_miss = finish_counts(params, st_done, job_done, live)

    # hold the lock while the unit is in progress; release at the boundary
    lock_on = picked & ~done_any
    is_rr = params.policy == P.POLICY_IDS["rr"]
    rr_cursor = torch.where(is_rr & done_any,
                            torch.remainder(tk_sel + 1, n_tasks),
                            st.rr_cursor).to(_I32)
    sel_hot = _oh_eq(tk_sel, n_tasks)
    minus1 = torch.full_like(sel, -1)
    if trace:
        # only the selected slot can complete: one word per step; exited
        # >= 0 always holds at job_done (full_mand backfills it)
        jd_sel = _take1(job_done, sel)
        if q_active_pre is not None:
            jd_sel = jd_sel & _take1(q_active_pre, sel)
        tr_comp = torch.where(
            jd_sel, ((_take1(st.q_job, sel) + 1) << 11) + (tk_sel << 6)
            + (_take1(exited, sel) + 2), 0).to(_I32)
        tr_comp_dl = _take1(st.q_deadline, sel)
    out = st._replace(
        energy=e_new,
        was_off=was_off,
        rr_cursor=rr_cursor,
        lock_slot=torch.where(lock_on, sel, minus1),
        lock_job=torch.where(lock_on, _take1(st.q_job, sel), minus1),
        q_active=st.q_active & ~job_done,
        q_unit=unit,
        q_time_left=time_left,
        q_exited=exited,
        q_last_pred=last_pred,
        q_mand_time=mand_time,
        m_scheduled=st.m_scheduled + d_sched,
        m_correct=st.m_correct + d_corr,
        m_misses=st.m_misses + d_miss,
        m_units=st.m_units + (done_any[..., None] & sel_hot).to(_I32),
        m_optional=st.m_optional + (
            (done_any & ~_take1(mandatory, sel))[..., None]
            & sel_hot).to(_I32),
        m_reboots=st.m_reboots + (reboot & (st.m_busy > 0)).to(_I32),
        m_busy=st.m_busy + torch.where(run, dt_t, zero),
        m_idle=st.m_idle + idle_inc,
        m_wasted=st.m_wasted + torch.where(reboot, 0.5 * frag_t, zero),
    )
    if trace:
        return out, (tr_comp, tr_comp_dl)
    return out


def device_step(params: StepParams, st: DeviceCarry, t,
                statics: StepStatics, t_end=None, trace: bool = False):
    """One full transition: admit -> expire -> pick -> apply.  Callers
    with the integer step index pass ``t_end = (i + 1) * dt``.

    ``trace`` additionally returns the step's :class:`StepTrace` (the same
    stages and ops, plus the descriptor words)."""
    if trace:
        act0 = st.q_active
        st, (adm, ev, ev_dl) = admit(params, st, t, statics, trace=True)
        st, (exp, exp_dl) = drop_expired(params, st, t, trace=True,
                                         q_active_pre=act0)
        sel, picked, run, e_new = pick(params, st, t, statics)
        st, (comp, comp_dl) = apply_step(
            params, st, t, sel, picked, run, e_new, statics, t_end=t_end,
            trace=True, q_active_pre=act0)
        return st, StepTrace(adm=adm, evict=ev, evict_dl=ev_dl, expire=exp,
                             expire_dl=exp_dl, complete=comp,
                             complete_dl=comp_dl)
    st = admit(params, st, t, statics)
    st = drop_expired(params, st, t)
    sel, picked, run, e_new = pick(params, st, t, statics)
    return apply_step(params, st, t, sel, picked, run, e_new, statics,
                      t_end=t_end)


class StepEvents(NamedTuple):
    """Observable events of a transition, derived purely from the
    ``(before, after)`` carry pair (the telemetry's reference fold).  The
    counters are differences of the ``m_*`` accumulators, so telemetry
    totals reconcile with :class:`StepResult`; a slot recycled by an
    overflow-evict in the same step reports its pre-step registers."""

    releases: torch.Tensor    # (...,) i32: jobs released this step
    misses: torch.Tensor      # (...,) i32: deadline misses this step
    scheduled: torch.Tensor   # (...,) i32: on-time completions this step
    retired: torch.Tensor     # (..., Q) bool: slots that left the queue
    slack: torch.Tensor       # (..., Q) f32: deadline - t_end
    exit_depth: torch.Tensor  # (..., Q) i32: q_exited at retirement
    power_fail: torch.Tensor  # (...,) bool: powered down this step
    reboots: torch.Tensor     # (...,) i32: reboot-count delta
    queue_occ: torch.Tensor   # (...,) i32: active slots after the step
    energy: torch.Tensor      # (...,) f32: capacitor energy after the step


def step_events(st0: DeviceCarry, st1: DeviceCarry, t,
                statics: StepStatics, t_end=None) -> StepEvents:
    """:class:`StepEvents` of one transition from its before/after carries
    (read-only).  ``t_end`` defaults to ``t + dt``; the compiled reference
    recomputes ``t = f32(i) * dt`` beside the sum and contracts the two
    into one rounding, so callers that know ``i`` pass ``fma(i, dt, dt)``
    (:func:`event_clock`)."""
    recycled = st0.q_active & st1.q_active & (
        (st1.q_job != st0.q_job) | (st1.q_task != st0.q_task))
    retired = (st0.q_active & ~st1.q_active) | recycled
    if t_end is None:
        t_end = t + statics.dt
    return StepEvents(
        releases=(st1.next_rel - st0.next_rel).sum(-1, dtype=_I32),
        misses=(st1.m_misses - st0.m_misses).sum(-1, dtype=_I32),
        scheduled=(st1.m_scheduled - st0.m_scheduled).sum(-1, dtype=_I32),
        retired=retired,
        slack=st0.q_deadline - t_end[..., None],
        exit_depth=torch.where(recycled, st0.q_exited, st1.q_exited),
        power_fail=st1.was_off & ~st0.was_off,
        reboots=(st1.m_reboots - st0.m_reboots).to(_I32),
        queue_occ=st1.q_active.sum(-1, dtype=_I32),
        energy=st1.energy.to(_F32),
    )


def event_clock(i, dt: float, device) -> torch.Tensor:
    """``f32(i) * dt + dt`` rounded once (f32 ``i`` may be a tensor of
    step indices): the end-of-step clock the compiled reference forms
    wherever it recomputes ``t = f32(i) * dt`` beside ``t + dt`` (the
    telemetry's slack reductions and its reference fold)."""
    i = torch.as_tensor(i, device=device).to(_F32)
    return fma_f32(i, dt, dt)


def finalize(params: StepParams, st: DeviceCarry,
             statics: StepStatics, live: bool = False) -> StepResult:
    """Flush live jobs and count never-admitted releases as misses; emit
    both the per-task ``(..., K)`` counters and their aggregates."""
    d_sched, d_corr, d_miss = finish_counts(params, st, st.q_active, live)
    unreleased = params.n_releases - st.next_rel
    t_sched = st.m_scheduled + d_sched
    t_corr = st.m_correct + d_corr
    t_miss = st.m_misses + d_miss + unreleased

    def total(x):
        return x.sum(-1, dtype=_I32)

    return StepResult(
        released=total(params.n_releases),
        scheduled=total(t_sched),
        correct=total(t_corr),
        deadline_misses=total(t_miss),
        units_executed=total(st.m_units),
        optional_units=total(st.m_optional),
        busy_time=st.m_busy,
        idle_no_energy=st.m_idle,
        reboots=st.m_reboots,
        wasted_reexec=st.m_wasted,
        sim_time=torch.full(st.m_busy.shape, statics.horizon, dtype=_F32,
                            device=st.m_busy.device),
        task_released=params.n_releases,
        task_scheduled=t_sched,
        task_correct=t_corr,
        task_misses=t_miss,
        task_units=st.m_units,
        task_optional=st.m_optional,
    )


def step_clock(i: int, dt: float, device) -> torch.Tensor:
    """The replay clock ``f32(i) * f32(dt)`` as an f32 0-d tensor: one
    correctly rounded product, formed on the host."""
    t = np.float32(i) * np.float32(dt)
    return torch.full((), float(t), dtype=_F32, device=device)


def run_steps(params: StepParams, st: DeviceCarry, i0: int, n_steps: int,
              statics: StepStatics) -> DeviceCarry:
    """``n_steps`` calls of :func:`device_step` from step index ``i0`` on
    the replay clock ``t = i * dt``, ``t_end = (i + 1) * dt``."""
    dev = params.policy.device
    for i in range(i0, i0 + n_steps):
        st = device_step(params, st, step_clock(i, statics.dt, dev), statics,
                         t_end=step_clock(i + 1, statics.dt, dev))
    return st


def simulate_device(params: StepParams, statics: StepStatics) -> StepResult:
    """Simulate the device(s) of ``params`` over the whole horizon
    (:func:`run_steps` from the initial carry, then :func:`finalize`).
    ``params`` may carry leading batch axes or none (one device)."""
    st = run_steps(params, init_carry(params, statics), 0, statics.n_steps,
                   statics)
    return finalize(params, st, statics)
