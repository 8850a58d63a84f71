"""Fixed-timestep fleet simulator over the step core (port of
:mod:`repro.fleet.simulator`).

It steps the whole fleet — capacitor energies, fixed-size job queues,
harvester event streams — one timestep at a time.  The step core
(:mod:`repro_torch.core.step`) is batch-polymorphic, so a step of the whole
fleet is one call; there is no ``vmap``.  One call therefore evaluates a
whole policy x eta x harvester x capacitor x seed grid.  The clock is the
replay clock: step ``i`` runs at ``t = f32(i) * dt`` and ends at ``t_end =
f32(i + 1) * dt``, one correctly rounded product each.

Three execution modes (:data:`FLEET_MODES`), equal on every bit:

* ``"vmap"``: the batched step core, plain PyTorch (no kernel of ours);
* ``"pallas"``: admit -> drop-expired -> pick inputs -> the
  ``fleet_priority`` kernel (one launch per step) -> apply;
* ``"fused"``: the whole segment in ONE launch of the ``fleet_fused_steps``
  kernel.

The mode names are the reference's.  :func:`simulate_fleet` runs the whole
horizon; :func:`run_segments` runs it in chunks, hands the full carry to a
host ``hook`` at each boundary (which may rewrite the tunable config
fields) and resumes from a carry.

``telemetry=`` (a :class:`repro_torch.telemetry.TelemetryConfig`) carries a
``(D, ...)`` :class:`repro_torch.telemetry.Telemetry` beside the carry in
the ``vmap`` and ``pallas`` modes: each step emits the tier's columns
(:mod:`repro_torch.telemetry.trace`), the segment reduces them once, and
at the ``"full"`` tier the rare ring and histogram events are folded on
the host.  The simulation is the same bit for bit either way.
``mode="fused"`` rejects it, as the reference does.

``mesh=`` (:func:`simulate_fleet_sharded`, :func:`run_segments`) cuts the
device axis over a :class:`repro_torch.launch.mesh.Mesh` by
:func:`repro_torch.launch.sharding.shard_fleet_config`: each block runs on
its own mesh device, in block order, and the results are joined on the
first one and sliced back to the real devices, equal bit for bit to the
run without a mesh.
"""
from __future__ import annotations

import inspect
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..core import step as S
from ..kernels import fleet_priority as FP
from ..kernels import fleet_step as FS
from ..telemetry import export as T_export
from ..telemetry import state as T
from ..telemetry import trace as T_trace
from .state import DeviceState, FleetConfig, FleetResult, FleetStatics

#: the FleetConfig fields adaptation hooks may rewrite mid-trajectory
TUNABLE_FIELDS = ("eta", "e_opt", "exit_thr", "use_exit_thr", "persistent")

#: execution modes of the time loop (see the module docstring)
FLEET_MODES = ("vmap", "pallas", "fused")

# hook signature: (segment_index, t_end, cfg, carry) -> new cfg or None
# (hooks that also declare a ``telemetry`` keyword receive the cumulative
# TelemetrySummary when telemetry is on)
SegmentHook = Callable[[int, float, FleetConfig, DeviceState],
                       Optional[FleetConfig]]


def _resolve_mode(mode: Optional[str],
                  use_pallas: Optional[bool] = None) -> str:
    """Fold the legacy ``use_pallas`` flag and ``mode`` into one mode
    string.  ``use_pallas`` is DEPRECATED: passing it (either value) warns.
    An explicit ``mode`` wins when both are given."""
    if use_pallas is not None:
        warnings.warn(
            "use_pallas= is deprecated; pass mode='pallas' (or 'vmap' / "
            "'fused') instead", DeprecationWarning, stacklevel=3)
        if mode is None:
            return "pallas" if use_pallas else "vmap"
    if mode is None:
        return "vmap"
    if mode not in FLEET_MODES:
        raise ValueError(f"mode must be one of {FLEET_MODES}, got {mode!r}")
    return mode


def init_fleet(cfg: FleetConfig, statics: FleetStatics) -> DeviceState:
    """The t=0 carry of every device in ``cfg`` (the value
    :func:`run_segments` accepts and returns between chunks)."""
    return S.init_carry(cfg, statics)


def finalize_fleet(cfg: FleetConfig, states: DeviceState,
                   statics: FleetStatics, live: bool = False) -> FleetResult:
    """Flush the carry into a :class:`FleetResult` — the step core's
    batch-polymorphic :func:`repro_torch.core.step.finalize` over the
    device axis.  ``live`` counts correctness from the live registers."""
    return S.finalize(cfg, states, statics, live)


def _pick_kernel(cfg: FleetConfig, states: DeviceState, t,
                 statics: FleetStatics):
    """The pick stage through the ``fleet_priority`` kernel: the plain
    per-slot gathers, then one launch for the whole fleet."""
    (laxity, utility, mandatory, gate_e, drain, power, forced,
     _rank) = S.pick_inputs(cfg, states, t, statics)
    return FP.fleet_priority(
        cfg.policy, states.q_active, laxity, states.q_release, utility,
        mandatory, cfg.alpha, cfg.beta, cfg.eta, cfg.persistent,
        states.energy, cfg.e_opt, power, cfg.capacity, gate_e, drain,
        forced, states.q_task, states.rr_cursor,
        n_tasks=cfg.period.shape[-1], dt=statics.dt)


def _pallas_step(cfg: FleetConfig, states: DeviceState, i: int,
                 statics: FleetStatics, trace: bool = False):
    """One fleet timestep at step index ``i`` with the pick in kernel A;
    ``trace`` also returns the step's :class:`~repro_torch.core.step
    .StepTrace` (the same stages and ops, plus the descriptor words)."""
    dev = cfg.policy.device
    t = S.step_clock(i, statics.dt, dev)
    t_end = S.step_clock(i + 1, statics.dt, dev)
    if not trace:
        states = S.admit(cfg, states, t, statics)
        states = S.drop_expired(cfg, states, t)
        sel, picked, run, e_new = _pick_kernel(cfg, states, t, statics)
        return S.apply_step(cfg, states, t, sel, picked, run, e_new, statics,
                            t_end=t_end)
    act0 = states.q_active
    states, (adm, ev, ev_dl) = S.admit(cfg, states, t, statics, trace=True)
    states, (exp, exp_dl) = S.drop_expired(cfg, states, t, trace=True,
                                           q_active_pre=act0)
    sel, picked, run, e_new = _pick_kernel(cfg, states, t, statics)
    states, (comp, comp_dl) = S.apply_step(
        cfg, states, t, sel, picked, run, e_new, statics, t_end=t_end,
        trace=True, q_active_pre=act0)
    return states, S.StepTrace(adm=adm, evict=ev, evict_dl=ev_dl,
                               expire=exp, expire_dl=exp_dl, complete=comp,
                               complete_dl=comp_dl)


def _fleet_step(cfg: FleetConfig, states: DeviceState, i: int,
                statics: FleetStatics, mode: str, trace: bool = False):
    """One fleet timestep in the ``vmap`` or ``pallas`` mode."""
    if mode == "pallas":
        return _pallas_step(cfg, states, i, statics, trace)
    dev = cfg.policy.device
    return S.device_step(cfg, states, S.step_clock(i, statics.dt, dev),
                         statics, t_end=S.step_clock(i + 1, statics.dt, dev),
                         trace=trace)


def _run_steps(cfg: FleetConfig, states: DeviceState, i0: int,
               statics: FleetStatics, n_steps: int,
               mode: str) -> DeviceState:
    """Advance ``n_steps`` timesteps from step index ``i0`` in ``mode``."""
    if mode == "fused":
        return FS.fleet_fused_steps(cfg, states, i0, statics=statics,
                                    n_steps=n_steps)
    for i in range(i0, i0 + n_steps):
        states = _fleet_step(cfg, states, i, statics, mode)
    return states


def pack_spec(cfg: FleetConfig, statics: FleetStatics) -> T_trace.PackSpec:
    """The full tier's bit layout for ``cfg`` (``U + 1`` depth bins)."""
    return T_trace.make_pack_spec(int(cfg.period.shape[-1]),
                                  statics.queue_size,
                                  int(cfg.unit_time.shape[-1]) + 1)


def _run_steps_tel(cfg: FleetConfig, states: DeviceState, tel: T.Telemetry,
                   i0: int, statics: FleetStatics, n_steps: int, mode: str,
                   tcfg: T.TelemetryConfig):
    """The telemetry-carrying twin of :func:`_run_steps`: each step emits
    the columns of the tier ``tcfg.level``, the segment reduces them into
    ``tel`` once, and at the full tier the rare ring and histogram events
    are folded on the host (the result back on the telemetry's device)."""
    st0, ys = states, []
    if tcfg.level == "counters":
        for i in range(i0, i0 + n_steps):
            states = _fleet_step(cfg, states, i, statics, mode)
            ys.append(T_trace.emit_counters(states))
        ys = [torch.stack(c) for c in zip(*ys)]
        return states, T_trace.reduce_counters(tel, st0, states, ys, n_steps)
    spec = pack_spec(cfg, statics)
    for i in range(i0, i0 + n_steps):
        new, tr = _fleet_step(cfg, states, i, statics, mode, trace=True)
        ys.append(T_trace.emit_full(spec, tr, states, new))
        states = new
    ys = [torch.stack(c) for c in zip(*ys)]
    tel, ring = T_trace.reduce_full(spec, tel, st0, states, ys, i0, n_steps,
                                    statics.dt)
    return states, T_trace.fold_events_host(spec, tel, ring, i0, statics.dt)


def _run_steps_tel_reference(cfg: FleetConfig, states: DeviceState,
                             tel: T.Telemetry, i0: int,
                             statics: FleetStatics, n_steps: int,
                             mode: str):
    """The slow reference: fold :func:`repro_torch.telemetry.state
    .record_step` from the before/after carry pair at every step.  Kept as
    the spec the collection paths are tested against."""
    dev = cfg.policy.device
    for i in range(i0, i0 + n_steps):
        t = S.step_clock(i, statics.dt, dev)
        new = _fleet_step(cfg, states, i, statics, mode)
        ev = S.step_events(states, new, t, statics,
                           t_end=S.event_clock(i, statics.dt, dev))
        tel = T.record_step(tel, ev, t)
        states = new
    return states, tel


def _no_fused_telemetry(mode: str, telemetry) -> None:
    if mode == "fused" and telemetry is not None:
        raise ValueError(
            "mode='fused' does not support telemetry; use mode='vmap'")


def simulate_fleet(cfg: FleetConfig, statics: FleetStatics,
                   use_pallas: Optional[bool] = None,
                   telemetry: Optional[T.TelemetryConfig] = None,
                   mode: Optional[str] = None):
    """Simulate every device of ``cfg`` over the whole horizon.

    Returns a :class:`FleetResult` of ``(D,)`` metrics plus ``(D, K)``
    per-task breakdowns, aligned with the device axis of ``cfg`` (see
    :func:`repro_torch.fleet.grid.sweep` for the grid bookkeeping).  All
    three modes are bit-exact against each other.  ``telemetry`` (not in
    ``mode="fused"``) returns ``(FleetResult, Telemetry)``, the result
    unchanged."""
    mode = _resolve_mode(mode, use_pallas)
    _no_fused_telemetry(mode, telemetry)
    states = init_fleet(cfg, statics)
    if telemetry is None:
        states = _run_steps(cfg, states, 0, statics, statics.n_steps, mode)
        return finalize_fleet(cfg, states, statics)
    tel = T.init_fleet_telemetry(telemetry, cfg)
    states, tel = _run_steps_tel(cfg, states, tel, 0, statics,
                                 statics.n_steps, mode, telemetry)
    return finalize_fleet(cfg, states, statics), tel


def _hook_takes_telemetry(hook) -> bool:
    """Does ``hook`` accept a ``telemetry=`` keyword (by name or through
    ``**kwargs``)?  Bare 4-argument hooks stay supported unchanged."""
    try:
        sig = inspect.signature(hook)
    except (TypeError, ValueError):
        return False
    params = sig.parameters.values()
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return True
    return "telemetry" in sig.parameters


def _knob_change_mask(old_cfg: FleetConfig, new_cfg: FleetConfig):
    """(D,) bool numpy: which devices had any :data:`TUNABLE_FIELDS` leaf
    rewritten by a hook (a host compare, once per segment boundary)."""
    changed = None
    for f in TUNABLE_FIELDS:
        a = T_export._host(getattr(old_cfg, f))
        b = T_export._host(getattr(new_cfg, f))
        diff = a != b
        while diff.ndim > 1:          # per-task knobs: any task changed
            diff = diff.any(axis=-1)
        changed = diff if changed is None else (changed | diff)
    return changed


def run_segments(cfg: FleetConfig, statics: FleetStatics,
                 n_segments: int = 1, *,
                 hook: Optional[SegmentHook] = None,
                 carry: Optional[DeviceState] = None,
                 start_step: int = 0,
                 use_pallas: Optional[bool] = None,
                 mode: Optional[str] = None,
                 mesh=None,
                 telemetry: Optional[T.TelemetryConfig] = None,
                 telemetry_carry: Optional[T.Telemetry] = None):
    """Segment-at-a-time fleet simulation over the checkpointable carry.

    Splits steps ``[start_step, statics.n_steps)`` into ``n_segments``
    contiguous chunks (sizes from ``np.array_split``) and materialises the
    full carry at every boundary.  After each segment the host
    ``hook(seg, t_end, cfg, carry)`` runs (``t_end = i0 * dt``, the
    boundary's clock) and may return a new FleetConfig — rewriting tunable
    fields (:data:`TUNABLE_FIELDS`) mid-trajectory — or ``None`` to keep
    the current one.  ``carry`` + ``start_step`` resume an earlier run; the
    clock is absolute, so resuming does not restart it at zero.  With no
    hook the chunked run is bit-identical to :func:`simulate_fleet` for any
    ``n_segments``; ``mode="fused"`` launches the kernel once per segment.

    ``telemetry`` threads a ``(D, ...)`` telemetry beside the carry and
    returns ``(FleetResult, DeviceState, Telemetry)``; a hook that
    declares ``telemetry=`` then receives the cumulative
    :func:`~repro_torch.telemetry.summarize` at each boundary, and config
    rewrites by a hook are stamped as ``knob_update`` events.
    ``telemetry_carry`` resumes a prior telemetry the way ``carry``
    resumes the simulation.  The simulation is the same either way.

    ``mesh`` cuts the device axis over the mesh as
    :func:`simulate_fleet_sharded` does; the carry and the telemetry are
    placed like the config (:func:`repro_torch.launch.sharding
    .shard_fleet_carry`).  The hook sees the padded device axis, joined on
    the first mesh device; a config it returns is placed again, so config
    and carry stay aligned block for block.  The result, carry and
    telemetry are sliced back to the real devices.  ``mode="fused"`` with a
    mesh is the reference's ``ValueError``.

    Returns ``(FleetResult, DeviceState)``: the finalized metrics and the
    end-of-horizon carry (plus the telemetry when it is on).
    """
    from ..launch import sharding as SH

    mode = _resolve_mode(mode, use_pallas)
    _no_fused_telemetry(mode, telemetry)
    if mode == "fused" and mesh is not None:
        raise ValueError("mode='fused' does not support mesh sharding yet")
    remaining = statics.n_steps - int(start_step)
    if not 0 <= int(start_step) <= statics.n_steps:
        raise ValueError(
            f"start_step must be in [0, {statics.n_steps}], got {start_step}")
    if not 1 <= n_segments <= max(remaining, 1):
        raise ValueError(
            f"n_segments must be in [1, {max(remaining, 1)}], "
            f"got {n_segments}")
    if telemetry is None and telemetry_carry is not None:
        raise ValueError("telemetry_carry requires telemetry=TelemetryConfig")

    def place(tree):
        """``tree`` as per-block trees: itself without a mesh."""
        if mesh is None:
            return [tree]
        return SH.blocks(SH.shard_fleet_carry(mesh, tree))

    n_real = cfg.n_devices
    cfgs = place(cfg)
    carries = ([init_fleet(c, statics) for c in cfgs] if carry is None
               else place(carry))
    tels = [None] * len(cfgs)
    if telemetry is not None:
        tels = ([T.init_fleet_telemetry(telemetry, c) for c in cfgs]
                if telemetry_carry is None else place(telemetry_carry))
    hook_wants_tel = (hook is not None and telemetry is not None
                      and _hook_takes_telemetry(hook))
    sizes = [len(c) for c in np.array_split(np.arange(remaining),
                                            n_segments)]
    i0 = int(start_step)
    for seg, n in enumerate(sizes):
        if n:
            for b, c in enumerate(cfgs):
                if telemetry is None:
                    carries[b] = _run_steps(c, carries[b], i0, statics, n,
                                            mode)
                else:
                    carries[b], tels[b] = _run_steps_tel(
                        c, carries[b], tels[b], i0, statics, n, mode,
                        telemetry)
            i0 += n
        if hook is not None:
            t_end = i0 * statics.dt
            cfg_all, carry_all = SH.join(cfgs), SH.join(carries)
            if hook_wants_tel:
                new_cfg = hook(seg, t_end, cfg_all, carry_all,
                               telemetry=T_export.summarize(SH.join(tels),
                                                            t_end))
            else:
                new_cfg = hook(seg, t_end, cfg_all, carry_all)
            if new_cfg is not None:
                if telemetry is not None:
                    changed = _knob_change_mask(cfg_all, new_cfg)
                    if changed is not None and changed.any():
                        tels = place(T.record_knob_updates(
                            SH.join(tels), changed, t_end))
                cfgs = place(new_cfg)
    res = SH.join([finalize_fleet(c, k, statics)
                   for c, k in zip(cfgs, carries)])
    res, carry = (SH.take_rows(x, n_real) for x in (res, SH.join(carries)))
    if telemetry is None:
        return res, carry
    return res, carry, SH.take_rows(SH.join(tels), n_real)


def simulate_fleet_sharded(cfg: FleetConfig, statics: FleetStatics,
                           mesh=None, use_pallas: Optional[bool] = None,
                           mode: Optional[str] = None) -> FleetResult:
    """:func:`simulate_fleet` with the device axis cut over ``mesh``.

    The fleet axis is independent (no device reads another's state), so
    each block of :func:`repro_torch.launch.sharding.shard_fleet_config`
    runs alone on its mesh device, in block order.  ``D`` is padded to a
    multiple of the mesh size by wrapping around the existing configs and
    the padding is cut from the joined result, so every real device's
    result equals the run without a mesh bit for bit.  On a mesh of one
    device that is the run itself.  ``mesh=None`` is :func:`simulate_fleet`.
    """
    mode = _resolve_mode(mode, use_pallas)
    if mesh is None:
        return simulate_fleet(cfg, statics, mode=mode)
    from ..launch import sharding as SH

    n_real = cfg.n_devices
    res = [simulate_fleet(b, statics, mode=mode)
           for b in SH.blocks(SH.shard_fleet_config(mesh, cfg))]
    return SH.take_rows(SH.join(res), n_real)
