"""The collection paths behind the telemetry-enabled loops (port of
:mod:`repro.telemetry.trace`).

* ``"counters"`` — each step emits three values it already computed
  (capacitor energy, active-slot count, the off-state flag); every counter
  is telescoped from the carry's own monotone accumulators (per-step
  deltas sum to end minus start) or reduced from the stacked ``(T, D)``
  columns once per segment.
* ``"full"`` — each step additionally runs the descriptor-emitting stages
  (:class:`repro_torch.core.step.StepTrace`) and bit-packs the step's
  event scalars into one or two ``int32`` columns (:class:`PackSpec`),
  plus two f32 slack columns.  Dense statistics reduce once per segment;
  the rare ring and histogram events are appended on the host by a sparse
  ``np.nonzero`` fold (:func:`fold_events_host`), O(events).

The port has no ``lax.scan``: the loops collect each step's columns and
stack them to ``(T, D)`` before the segment's reduction, which keeps the
reference's order: a segment sum from zero, then one add into the carry.
The float segment sums take XLA's own order over the step axis (windows of
32, :func:`repro_torch.kernels.l1_topk2.ordered_sum`).
Two products are one rounding, as the compiled reference forms them: the
end-of-step clock ``f32(i) * dt + dt`` and the slack term ``ssum - nret *
t_end``.  The host fold is numpy and keeps its two roundings.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import step as S
from ..core._fma import fma_f32
from ..kernels.l1_topk2 import ordered_sum
from .state import Telemetry

_F32 = torch.float32
_I32 = torch.int32

#: low bits of a descriptor word: exited + 2 (0 = no event)
_EXIT_MASK = 0x3F
#: per-step per-device miss/reboot ring payloads are packed in 4 bits
_EVB = 4


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static bit layout of the full-tier descriptor columns.

    Column 0 holds the header — power-fail flag, retirement count, misses,
    reboots, occupancy — then one ``depth`` field per retirement channel
    (``2K + 1``: the job-done completion plus a per-task eviction and
    expiry; each ``exit depth + 1``, 0 = no event).  Depth fields that do
    not fit in a column's 31 usable bits spill into further columns.
    """

    n_tasks: int
    n_bins: int
    b_nret: int
    b_occ: int
    b_depth: int
    off_miss: int
    off_dreb: int
    off_occ: int
    #: per retirement channel: (column index, bit offset)
    depth_fields: tuple
    n_cols: int

    @property
    def n_channels(self) -> int:
        return 2 * self.n_tasks + 1


@functools.lru_cache(maxsize=None)
def make_pack_spec(n_tasks: int, queue_size: int, n_bins: int) -> PackSpec:
    if 2 * n_tasks >= (1 << _EVB):
        raise ValueError(
            f"per-step miss payload needs more than {_EVB} bits "
            f"for {n_tasks} tasks")
    b_nret = max(1, int(np.ceil(np.log2(2 * n_tasks + 2))))
    b_occ = max(1, int(np.ceil(np.log2(queue_size + 1))))
    b_depth = max(1, int(np.ceil(np.log2(n_bins + 1))))
    off_miss = 1 + b_nret
    off_dreb = off_miss + _EVB
    off_occ = off_dreb + _EVB
    col, off = 0, off_occ + b_occ
    fields = []
    for _ in range(2 * n_tasks + 1):
        if off + b_depth > 31:
            col, off = col + 1, 0
        fields.append((col, off))
        off += b_depth
    return PackSpec(n_tasks=n_tasks, n_bins=n_bins, b_nret=b_nret,
                    b_occ=b_occ, b_depth=b_depth, off_miss=off_miss,
                    off_dreb=off_dreb, off_occ=off_occ,
                    depth_fields=tuple(fields), n_cols=col + 1)


def _telescope(tel: Telemetry, st0, st1, n_steps: int) -> Telemetry:
    """Counters the carry already accumulates: per-step deltas sum to end
    minus start."""
    def tele(a1, a0):
        d = a1 - a0
        return (d if d.dim() == tel.n_steps.dim() else d.sum(-1)).to(_I32)

    return tel._replace(
        c_release=tel.c_release + tele(st1.next_rel, st0.next_rel),
        c_miss=tel.c_miss + tele(st1.m_misses, st0.m_misses),
        c_sched=tel.c_sched + tele(st1.m_scheduled, st0.m_scheduled),
        c_reboot=tel.c_reboot + tele(st1.m_reboots, st0.m_reboots),
        n_steps=tel.n_steps + n_steps,
    )


# --------------------------------------------------------------------- #
# "counters" tier
# --------------------------------------------------------------------- #

def emit_counters(new):
    """One step's counters-tier columns: values the step already made."""
    occ = new.q_active.sum(-1).to(torch.int8)
    return new.energy.to(_F32), occ, new.was_off


def reduce_counters(tel: Telemetry, st0, st1, ys, n_steps: int) -> Telemetry:
    """The counters tier's segment reduction over the stacked ``(T, D)``
    columns ``ys`` of :func:`emit_counters`."""
    en, occ, woff = ys
    pf_first = (woff[0] & ~st0.was_off).to(_I32)
    pf_rest = (woff[1:] & ~woff[:-1]).sum(0, dtype=_I32)
    tel = _telescope(tel, st0, st1, n_steps)
    return tel._replace(
        c_power_fail=tel.c_power_fail + pf_first + pf_rest,
        occ_sum=tel.occ_sum + occ.to(_I32).sum(0, dtype=_I32),
        occ_max=torch.maximum(tel.occ_max, occ.amax(0).to(_I32)),
        energy_sum=tel.energy_sum + _step_sum(en),
        energy_min=torch.minimum(tel.energy_min, en.amin(0)),
    )


def _step_sum(col):
    """A ``(T, D)`` f32 column summed over its steps in XLA's order."""
    return ordered_sum(col.transpose(0, -1)).transpose(0, -1)


# --------------------------------------------------------------------- #
# "full" tier
# --------------------------------------------------------------------- #

def emit_full(spec: PackSpec, tr, st0, new):
    """One step's full-tier columns: the packed descriptor ints, the raw
    slack accumulators (sum / min of the retiring ``q_deadline``
    registers) and the energy."""
    channels = [(tr.complete > 0, tr.complete_dl, tr.complete)]
    for k in range(spec.n_tasks):
        channels.append((tr.evict[..., k] > 0, tr.evict_dl[..., k],
                         tr.evict[..., k]))
        channels.append((tr.expire[..., k] > 0, tr.expire_dl[..., k],
                         tr.expire[..., k]))
    nb = spec.n_bins
    dev = tr.complete.device
    shape = tr.complete.shape
    zero = torch.zeros((), dtype=_F32, device=dev)
    inf = torch.full((), float("inf"), dtype=_F32, device=dev)
    nret = torch.zeros(shape, dtype=_I32, device=dev)
    ssum = torch.zeros(shape, dtype=_F32, device=dev)
    smin = torch.full(shape, float("inf"), dtype=_F32, device=dev)
    depths = []
    for valid, dl, word in channels:
        exited = (word & _EXIT_MASK) - 2
        depth = torch.where(exited >= 0, exited.clamp(0, nb - 2), nb - 1)
        depths.append(torch.where(valid, depth + 1, 0))
        nret = nret + valid.to(_I32)
        ssum = ssum + torch.where(valid, dl, zero)
        smin = torch.minimum(smin, torch.where(valid, dl, inf))
    occ = new.q_active.sum(-1, dtype=_I32)
    miss = torch.clamp((new.m_misses - st0.m_misses).sum(-1, dtype=_I32),
                       max=(1 << _EVB) - 1)
    dreb = torch.clamp((new.m_reboots - st0.m_reboots).to(_I32),
                       max=(1 << _EVB) - 1)
    pf = (new.was_off & ~st0.was_off).to(_I32)
    cols = [torch.zeros(shape, dtype=_I32, device=dev)
            for _ in range(spec.n_cols)]
    cols[0] = (pf | (nret << 1) | (miss << spec.off_miss)
               | (dreb << spec.off_dreb) | (occ << spec.off_occ))
    for dth, (ci, off) in zip(depths, spec.depth_fields):
        cols[ci] = cols[ci] | (dth.to(_I32) << off)
    return (*cols, ssum, smin, new.energy.to(_F32))


def reduce_full(spec: PackSpec, tel: Telemetry, st0, st1, ys, i0: int,
                n_steps: int, dt: float):
    """The full tier's segment reduction over the stacked ``(T, D)``
    columns ``ys`` of :func:`emit_full`.  Returns the advanced telemetry
    and the ring-ingredient columns for :func:`fold_events_host` (the
    histogram is folded there too)."""
    *cols, ssum, smin, en = ys
    pk = cols[0]
    steps = torch.arange(i0, i0 + n_steps, device=pk.device)
    t_end = S.event_clock(steps, dt, pk.device)[:, None]
    nret = (pk >> 1) & ((1 << spec.b_nret) - 1)
    occ = (pk >> spec.off_occ) & ((1 << spec.b_occ) - 1)
    evm = (1 << _EVB) - 1
    i8 = torch.int8
    evt = ((((pk >> spec.off_miss) & evm) > 0).to(i8)
           | ((nret > 0).to(i8) << 1)
           | ((pk & 1).to(i8) << 2)
           | ((((pk >> spec.off_dreb) & evm) > 0).to(i8) << 3))
    tel = _telescope(tel, st0, st1, n_steps)
    tel = tel._replace(
        c_retired=tel.c_retired + nret.sum(0, dtype=_I32),
        c_power_fail=tel.c_power_fail + (pk & 1).sum(0, dtype=_I32),
        slack_sum=tel.slack_sum
        + _step_sum(fma_f32(-nret.to(_F32), t_end, ssum)),
        slack_min=torch.minimum(tel.slack_min, (smin - t_end).amin(0)),
        occ_sum=tel.occ_sum + occ.sum(0, dtype=_I32),
        occ_max=torch.maximum(tel.occ_max, occ.amax(0)),
        energy_sum=tel.energy_sum + _step_sum(en),
        energy_min=torch.minimum(tel.energy_min, en.amin(0)),
    )
    return tel, (*cols, ssum, en, evt)


def fold_events_host(spec: PackSpec, tel: Telemetry, ring, i0: int,
                     dt: float) -> Telemetry:
    """Sparse host fold of the rare per-step events into the ring buffers
    and the exit histogram.  ``ring`` holds the ``(T, D)`` packed columns,
    slack-sum and energy columns and event bytes of :func:`reduce_full`
    (tensors or numpy).  O(events) after one ``np.nonzero`` pass; the
    fields it rewrites go back to the telemetry's device."""
    *cols, ssum, en, evt = [_np(c) for c in ring]
    tz, dz = np.nonzero(evt)
    w = evt[tz, dz]
    pk_e = cols[0][tz, dz]
    nret_e = (pk_e >> 1) & ((1 << spec.b_nret) - 1)
    miss_e = (pk_e >> spec.off_miss) & ((1 << _EVB) - 1)
    dreb_e = (pk_e >> spec.off_dreb) & ((1 << _EVB) - 1)

    ssum_e = ssum[tz, dz]
    en_e = en[tz, dz]

    # exit histogram from the depth fields of retire events
    hist = _np(tel.exit_hist).copy()
    rmask = (w & 2) > 0
    rd_ = dz[rmask]
    dmask = (1 << spec.b_depth) - 1
    for ci, off in spec.depth_fields:
        dth = ((pk_e[rmask] if ci == 0
                else cols[ci][tz, dz][rmask]) >> off) & dmask
        has = dth > 0
        np.add.at(hist, (rd_[has], dth[has] - 1), 1)

    # ring append in the reference's push order: device-major, then step,
    # then kind (miss, complete, power_fail, reboot)
    kk, tk, dk, ei = [], [], [], []
    idx = np.arange(w.shape[0])
    for k in range(4):
        m = (w >> k) & 1 > 0
        kk.append(np.full(int(m.sum()), k, np.int64))
        tk.append(tz[m])
        dk.append(dz[m])
        ei.append(idx[m])
    kk, tk, dk, ei = map(np.concatenate, (kk, tk, dk, ei))
    order = np.lexsort((kk, tk, dk))
    kk, tk, dk, ei = kk[order], tk[order], dk[order], ei[order]

    head0 = _np(tel.ring_head).astype(np.int64)
    rt = _np(tel.ring_t).copy()
    rk = _np(tel.ring_kind).copy()
    rv = _np(tel.ring_val).copy()
    R = rt.shape[1]
    cnt = np.bincount(dk, minlength=head0.shape[0])
    starts = np.cumsum(cnt) - cnt
    j = head0[dk] + (np.arange(dk.shape[0]) - starts[dk])
    new_head = head0 + cnt
    keep = j >= new_head[dk] - R
    nr = nret_e[ei]
    t_end = (tk + int(i0)).astype(np.float32) * np.float32(dt) + np.float32(dt)
    valc = (ssum_e[ei] - nr * t_end) / np.maximum(nr, 1).astype(np.float32)
    val = np.select(
        [kk == 0, kk == 1, kk == 2],
        [miss_e[ei].astype(np.float32), valc, en_e[ei]],
        dreb_e[ei].astype(np.float32))
    dkk, slot = dk[keep], j[keep] % R
    rt[dkk, slot] = np.float32(tk[keep] + int(i0)) * np.float32(dt)
    rk[dkk, slot] = kk[keep]
    rv[dkk, slot] = val[keep]
    dev = tel.ring_head.device
    return tel._replace(
        exit_hist=torch.from_numpy(hist).to(dev),
        ring_t=torch.from_numpy(rt).to(dev),
        ring_kind=torch.from_numpy(rk).to(dev),
        ring_val=torch.from_numpy(rv).to(dev),
        ring_head=torch.from_numpy(new_head.astype(np.int32)).to(dev))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
