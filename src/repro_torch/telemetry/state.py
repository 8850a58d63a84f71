"""The telemetry carry: counters, extrema, an exit-depth histogram and a
fixed-size event ring (port of :mod:`repro.telemetry.state`).

* :class:`TelemetryConfig` — hashable static configuration.  ``None``
  wherever a config is accepted keeps every instrumented path out of the
  run: the plain path's ops are the uninstrumented ones.
* :class:`Telemetry` — a NamedTuple of tensors with the reference's dtypes
  (i32 counters, f32 sums and extrema).  Every function here is
  batch-polymorphic: any leading axes (the fleet's device axis) ride along
  on every leaf, as on :class:`repro_torch.core.step.DeviceCarry`; there is
  no ``vmap``.
* :func:`record_step` — folds one transition's
  :class:`repro_torch.core.step.StepEvents` into the telemetry.  Events
  are carry deltas (:func:`repro_torch.core.step.step_events`), so
  telemetry cannot change a bit of the simulation.

Ring semantics: ``ring_head`` counts every event ever pushed; the write
index is ``head % ring_size``, so overflow overwrites the oldest entry
while the head keeps the true total.  At most one event per kind is
pushed per step, carrying the step's aggregate as its value.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

_F32 = torch.float32
_I32 = torch.int32

#: event kinds recorded in the ring buffer (ring_kind values)
EVENT_KINDS = {
    "miss": 0,         # val = deadline misses this step
    "complete": 1,     # val = mean deadline slack of this step's completions
    "power_fail": 2,   # val = capacitor energy at the power-down
    "reboot": 3,       # val = reboots this step
    "knob_update": 4,  # val = 1.0; host-pushed at adaptation boundaries
}
EVENT_NAMES = {v: k for k, v in EVENT_KINDS.items()}


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Hashable static telemetry configuration.

    ``level`` selects the collection tier: ``"counters"`` (default) —
    event counters, occupancy and energy running stats, telescoped from
    the carry's own accumulators or reduced once per segment from three
    per-step columns; ``"full"`` — additionally the retirement slack, the
    exit-depth histogram and the event ring, from packed per-step
    descriptors (:mod:`repro_torch.telemetry.trace`).  ``ring_size``
    bounds the per-device event ring.
    """

    ring_size: int = 256
    level: str = "counters"

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError(
                f"ring_size must be >= 1, got {self.ring_size}")
        if self.level not in ("counters", "full"):
            raise ValueError(
                f"level must be 'counters' or 'full', got {self.level!r}")


class Telemetry(NamedTuple):
    """Telemetry tensors (fleet: leading ``D`` on every leaf).

    The counters accumulate the same deltas as the step core's ``m_*``
    accumulators, so cumulative telemetry reconciles exactly with them at
    any segment boundary.
    """

    c_release: torch.Tensor     # i32: jobs released
    c_miss: torch.Tensor        # i32: deadline misses
    c_sched: torch.Tensor       # i32: on-time completions
    c_retired: torch.Tensor     # i32: queue slots retired
    c_power_fail: torch.Tensor  # i32: run -> off transitions
    c_reboot: torch.Tensor      # i32: reboots after a power-down
    c_knob: torch.Tensor        # i32: controller knob updates
    slack_sum: torch.Tensor     # f32: deadline slack at retirement
    slack_min: torch.Tensor     # f32: +inf until the first retirement
    exit_hist: torch.Tensor     # (U + 1,) i32; bin U = never exited
    occ_sum: torch.Tensor       # i32: sum over steps of active slots
    occ_max: torch.Tensor       # i32
    energy_sum: torch.Tensor    # f32: sum over steps of capacitor energy
    energy_min: torch.Tensor    # f32
    n_steps: torch.Tensor       # i32: steps observed
    ring_t: torch.Tensor        # (R,) f32 event times
    ring_kind: torch.Tensor     # (R,) i32 EVENT_KINDS values
    ring_val: torch.Tensor      # (R,) f32 per-kind payload
    ring_head: torch.Tensor     # i32: total events ever pushed


def init_telemetry(tcfg: TelemetryConfig, n_units: int, lead: tuple = (),
                   device="cuda") -> Telemetry:
    """The t=0 telemetry with leading axes ``lead`` (``()`` for one
    device); the exit histogram gets ``n_units + 1`` bins."""
    r = tcfg.ring_size

    def full(shape, value, dtype):
        return torch.full(tuple(lead) + shape, value, dtype=dtype,
                          device=device)

    zero_i, zero_f = full((), 0, _I32), full((), 0.0, _F32)
    return Telemetry(
        c_release=zero_i, c_miss=zero_i.clone(), c_sched=zero_i.clone(),
        c_retired=zero_i.clone(), c_power_fail=zero_i.clone(),
        c_reboot=zero_i.clone(), c_knob=zero_i.clone(),
        slack_sum=zero_f, slack_min=full((), float("inf"), _F32),
        exit_hist=full((n_units + 1,), 0, _I32),
        occ_sum=zero_i.clone(), occ_max=zero_i.clone(),
        energy_sum=zero_f.clone(),
        energy_min=full((), float("inf"), _F32),
        n_steps=zero_i.clone(),
        ring_t=full((r,), 0.0, _F32),
        ring_kind=full((r,), -1, _I32),
        ring_val=full((r,), 0.0, _F32),
        ring_head=zero_i.clone(),
    )


def init_fleet_telemetry(tcfg: TelemetryConfig, cfg) -> Telemetry:
    """``(D, ...)`` telemetry for every device of a fleet config, on the
    config's device."""
    return init_telemetry(tcfg, int(cfg.unit_time.shape[-1]),
                          (cfg.n_devices,), cfg.policy.device)


def _push(tel: Telemetry, mask, kind: int, val, t) -> Telemetry:
    """Append one event where ``mask`` holds: a masked write of every
    device's slot ``head % R`` (a no-op where it does not)."""
    r = tel.ring_t.shape[-1]
    idx = torch.remainder(tel.ring_head, r)
    hot = (torch.arange(r, device=idx.device, dtype=_I32)
           == idx[..., None]) & mask[..., None]

    def put(old, value, dtype):
        value = torch.as_tensor(value, dtype=dtype, device=old.device)
        return torch.where(hot, value[..., None] if value.dim() else value,
                           old)

    return tel._replace(
        ring_t=put(tel.ring_t, t, _F32),
        ring_kind=put(tel.ring_kind, kind, _I32),
        ring_val=put(tel.ring_val, val, _F32),
        ring_head=tel.ring_head + mask.to(_I32),
    )


def record_step(tel: Telemetry, ev, t) -> Telemetry:
    """Fold one transition's :class:`~repro_torch.core.step.StepEvents`
    into the telemetry (``t``: the step's start time, the ring's clock).
    Rings receive at most one event per kind per step."""
    n_bins = tel.exit_hist.shape[-1]
    depth = torch.where(ev.exit_depth >= 0,
                        ev.exit_depth.clamp(0, n_bins - 2), n_bins - 1)
    bins = torch.arange(n_bins, device=depth.device, dtype=depth.dtype)
    hist_inc = (ev.retired[..., None]
                & (depth[..., None] == bins)).sum(-2, dtype=_I32)
    n_retired = ev.retired.sum(-1, dtype=_I32)
    zero = torch.zeros((), dtype=_F32, device=depth.device)
    inf = torch.full((), float("inf"), dtype=_F32, device=depth.device)
    slack_step = torch.where(ev.retired, ev.slack, zero).sum(-1)
    slack_min_step = torch.where(ev.retired, ev.slack, inf).amin(-1)

    tel = tel._replace(
        c_release=tel.c_release + ev.releases,
        c_miss=tel.c_miss + ev.misses,
        c_sched=tel.c_sched + ev.scheduled,
        c_retired=tel.c_retired + n_retired,
        c_power_fail=tel.c_power_fail + ev.power_fail.to(_I32),
        c_reboot=tel.c_reboot + ev.reboots,
        slack_sum=tel.slack_sum + slack_step,
        slack_min=torch.minimum(tel.slack_min, slack_min_step),
        exit_hist=tel.exit_hist + hist_inc,
        occ_sum=tel.occ_sum + ev.queue_occ,
        occ_max=torch.maximum(tel.occ_max, ev.queue_occ),
        energy_sum=tel.energy_sum + ev.energy,
        energy_min=torch.minimum(tel.energy_min, ev.energy),
        n_steps=tel.n_steps + 1,
    )
    mean_slack = slack_step / n_retired.clamp(min=1).to(_F32)
    tel = _push(tel, ev.misses > 0, EVENT_KINDS["miss"],
                ev.misses.to(_F32), t)
    tel = _push(tel, n_retired > 0, EVENT_KINDS["complete"], mean_slack, t)
    tel = _push(tel, ev.power_fail, EVENT_KINDS["power_fail"], ev.energy, t)
    tel = _push(tel, ev.reboots > 0, EVENT_KINDS["reboot"],
                ev.reboots.to(_F32), t)
    return tel


def record_anytime_step(tel: Telemetry, *, releases, misses, scheduled,
                        retired, slack_sum, slack_min, depth_hist,
                        occupancy, energy, t) -> Telemetry:
    """Fold one anytime-serving engine step (:mod:`repro_torch.serve
    .anytime`) into the telemetry: admissions, on-time / late completions,
    a ``(U + 1,)`` increment of per-token depths, the slack over this
    step's completions (``slack_min = +inf`` when none), busy slots and
    the energy.  Same ring semantics as :func:`record_step`."""
    i32 = [torch.as_tensor(v).to(_I32) for v in
           (releases, misses, scheduled, retired, occupancy)]
    releases, misses, scheduled, retired, occupancy = i32
    slack_sum = torch.as_tensor(slack_sum).to(_F32)
    energy = torch.as_tensor(energy).to(_F32)
    tel = tel._replace(
        c_release=tel.c_release + releases,
        c_miss=tel.c_miss + misses,
        c_sched=tel.c_sched + scheduled,
        c_retired=tel.c_retired + retired,
        slack_sum=tel.slack_sum + slack_sum,
        slack_min=torch.minimum(tel.slack_min,
                                torch.as_tensor(slack_min).to(_F32)),
        exit_hist=tel.exit_hist + torch.as_tensor(depth_hist).to(_I32),
        occ_sum=tel.occ_sum + occupancy,
        occ_max=torch.maximum(tel.occ_max, occupancy),
        energy_sum=tel.energy_sum + energy,
        energy_min=torch.minimum(tel.energy_min, energy),
        n_steps=tel.n_steps + 1,
    )
    mean_slack = slack_sum / retired.clamp(min=1).to(_F32)
    tel = _push(tel, misses > 0, EVENT_KINDS["miss"], misses.to(_F32), t)
    tel = _push(tel, retired > 0, EVENT_KINDS["complete"], mean_slack, t)
    return tel


def record_knob_updates(tel: Telemetry, changed, t) -> Telemetry:
    """Host-boundary event: an adaptation hook rewrote the tunable config
    fields of the devices in ``changed`` (a ``(D,)`` bool mask, numpy or
    tensor).  ``t`` (a python float) is rounded to f32 once."""
    if isinstance(changed, torch.Tensor):
        ch = changed.to(device=tel.c_knob.device, dtype=torch.bool)
    else:
        ch = torch.as_tensor(np.asarray(changed, bool),
                             device=tel.c_knob.device)
    tel = tel._replace(c_knob=tel.c_knob + ch.to(_I32))
    return _push(tel, ch, EVENT_KINDS["knob_update"], 1.0,
                 float(np.float32(t)))
