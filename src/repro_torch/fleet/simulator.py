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
fields) and resumes from a carry.  ``telemetry=`` and ``mesh=`` come with
later slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np

from ..core import step as S
from ..kernels import fleet_priority as FP
from ..kernels import fleet_step as FS
from .state import DeviceState, FleetConfig, FleetResult, FleetStatics

#: the FleetConfig fields adaptation hooks may rewrite mid-trajectory
TUNABLE_FIELDS = ("eta", "e_opt", "exit_thr", "use_exit_thr", "persistent")

#: execution modes of the time loop (see the module docstring)
FLEET_MODES = ("vmap", "pallas", "fused")

# hook signature: (segment_index, t_end, cfg, carry) -> new cfg or None
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


def _not_ported(**kw) -> None:
    for name, value in kw.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet (it comes with a later slice)")


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
                 statics: FleetStatics) -> DeviceState:
    """One fleet timestep at step index ``i`` with the pick in kernel A."""
    dev = cfg.policy.device
    t = S.step_clock(i, statics.dt, dev)
    states = S.admit(cfg, states, t, statics)
    states = S.drop_expired(cfg, states, t)
    sel, picked, run, e_new = _pick_kernel(cfg, states, t, statics)
    return S.apply_step(cfg, states, t, sel, picked, run, e_new, statics,
                        t_end=S.step_clock(i + 1, statics.dt, dev))


def _run_steps(cfg: FleetConfig, states: DeviceState, i0: int,
               statics: FleetStatics, n_steps: int,
               mode: str) -> DeviceState:
    """Advance ``n_steps`` timesteps from step index ``i0`` in ``mode``."""
    if mode == "fused":
        return FS.fleet_fused_steps(cfg, states, i0, statics=statics,
                                    n_steps=n_steps)
    if mode == "vmap":
        return S.run_steps(cfg, states, i0, n_steps, statics)
    for i in range(i0, i0 + n_steps):
        states = _pallas_step(cfg, states, i, statics)
    return states


def simulate_fleet(cfg: FleetConfig, statics: FleetStatics,
                   use_pallas: Optional[bool] = None, telemetry=None,
                   mode: Optional[str] = None) -> FleetResult:
    """Simulate every device of ``cfg`` over the whole horizon.

    Returns a :class:`FleetResult` of ``(D,)`` metrics plus ``(D, K)``
    per-task breakdowns, aligned with the device axis of ``cfg`` (see
    :func:`repro_torch.fleet.grid.sweep` for the grid bookkeeping).  All
    three modes are bit-exact against each other."""
    _not_ported(telemetry=telemetry)
    mode = _resolve_mode(mode, use_pallas)
    states = _run_steps(cfg, init_fleet(cfg, statics), 0, statics,
                        statics.n_steps, mode)
    return finalize_fleet(cfg, states, statics)


def run_segments(cfg: FleetConfig, statics: FleetStatics,
                 n_segments: int = 1, *,
                 hook: Optional[SegmentHook] = None,
                 carry: Optional[DeviceState] = None,
                 start_step: int = 0,
                 use_pallas: Optional[bool] = None,
                 mode: Optional[str] = None,
                 mesh=None, telemetry=None, telemetry_carry=None):
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

    Returns ``(FleetResult, DeviceState)``: the finalized metrics and the
    end-of-horizon carry.
    """
    _not_ported(mesh=mesh, telemetry=telemetry,
                telemetry_carry=telemetry_carry)
    mode = _resolve_mode(mode, use_pallas)
    remaining = statics.n_steps - int(start_step)
    if not 0 <= int(start_step) <= statics.n_steps:
        raise ValueError(
            f"start_step must be in [0, {statics.n_steps}], got {start_step}")
    if not 1 <= n_segments <= max(remaining, 1):
        raise ValueError(
            f"n_segments must be in [1, {max(remaining, 1)}], "
            f"got {n_segments}")
    if carry is None:
        carry = init_fleet(cfg, statics)
    sizes = [len(c) for c in np.array_split(np.arange(remaining),
                                            n_segments)]
    i0 = int(start_step)
    for seg, n in enumerate(sizes):
        if n:
            carry = _run_steps(cfg, carry, i0, statics, n, mode)
            i0 += n
        if hook is not None:
            new_cfg = hook(seg, i0 * statics.dt, cfg, carry)
            if new_cfg is not None:
                cfg = new_cfg
    return finalize_fleet(cfg, carry, statics), carry
