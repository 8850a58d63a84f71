"""Whole-segment fleet kernels: ``n_steps`` timesteps of every device in
ONE launch.

* :func:`fleet_fused_steps` (kernel B) replaces the Pallas TPU kernel
  ``repro/kernels/fleet_step.py:fleet_fused_steps``: per device and per
  step it runs the replay :func:`repro_torch.core.step.device_step`
  (admit -> drop-expired -> pick -> apply against the ``margins`` /
  ``passes`` / ``correct`` tables) on the replay clock ``t = (i0 + s) *
  dt``, ``t_end = (i0 + s + 1) * dt``.
* :func:`serve_fused_steps` (kernel C) replaces ``serve_fused_steps``: the
  same step in live mode, plus the classify of the completing unit against
  the centroid bank (the reference's window-32 L1 order, as kernel D sums
  it), the utility-pass latch and the outcome log, exactly as
  :func:`repro_torch.serve.fleet_engine.serve_step` does, on the live
  clock ``t = (i0 + s) * dt``, ``t_end = t + dt``.

Both CUDA kernels run the one copy of the step's stages on the card,
``csrc/replay_step.cuh``: the carry in registers, the device's tables in
shared memory and the per-slot values hoisted to the events that change
them.  Kernel B (``csrc/fleet_fused.cu``) runs one device per thread;
kernel C (``csrc/serve_fused.cu``) one device per warp, lane 0 running
the stages and the whole warp the classify of a completing unit.  What
bounds each kernel and why is noted in the sources.  Booleans stay
``torch.bool`` (one byte); the int32 packing of the reference exists for
the TPU compiler only.  Kernel C takes ``adapt=False`` only, like the
reference: bank adaptation propagates centroids through whole-model
convolutions, so the bank passes through unchanged.

Both kernels read the caller's carry and write every element of a new one;
C's wrapper also clones the outcome log, which the kernel updates in place.
The caller's carry is never written.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import step as S
from ..core.step import DeviceCarry, StepParams
from ..fleet.state import ServeCarry, ServeLog
from . import _build, _cost
from .l1_topk2 import window_plan

#: the kernels' largest instances: QC = 8 queue slots, KC = 8 tasks
QMAX = 8
KMAX = 8
_MAX_S = 32 ** 4      # the classify folds at most 3 window levels

#: launches of the CUDA kernels B and C (the plain versions never count)
fleet_launches = 0
serve_launches = 0


def fleet_fused_steps_plain(cfg: StepParams, carry: DeviceCarry, i0: int, *,
                            statics, n_steps: int) -> DeviceCarry:
    """The plain version of kernel B: ``n_steps`` calls of the replay
    ``device_step`` on the replay clock."""
    return S.run_steps(cfg, carry, i0, n_steps, statics)


def serve_fused_steps_plain(cfg, carry, tables, i0, job0, *, statics,
                            n_steps):
    """The plain version: ``n_steps`` calls of the batch-polymorphic
    ``serve_step`` (bank untouched)."""
    from ..serve.fleet_engine import serve_step

    dev, bank, log = carry
    for i in range(i0, i0 + n_steps):
        t = S.step_clock(i, statics.dt, cfg.policy.device)
        dev, log, _ = serve_step(cfg, tables, dev, bank, log, t, job0,
                                 statics=statics)
    return ServeCarry(dev=dev, bank=bank, log=log)


# --------------------------------------------------------------------- #
# The CUDA launch.
# --------------------------------------------------------------------- #

_CFG_FIELDS = ("policy", "imprecise", "is_edfm", "eta", "alpha", "beta",
               "persistent", "capacity", "e_man", "e_opt", "power_on",
               "clock_drift", "use_exit_thr", "exit_thr", "period",
               "rel_deadline", "fragments", "n_units", "n_releases",
               "unit_time", "unit_energy", "events")
#: kernel B also reads the replay tables
_FLEET_CFG_FIELDS = _CFG_FIELDS + ("margins", "passes", "correct")
_TABLE_FIELDS = ("centroids", "sel_feats", "labels", "clabels", "fidx",
                 "thr", "job0")
_SIZE_FIELDS = ("D", "K", "U", "Q", "W", "C", "F", "S", "NE",
                "shared_bank", "per_dev_tables", "i0", "n_steps")
#: kernel C's classify plan, l1_topk2.window_plan(S)
_PLAN_FIELDS = ("nwin", "lo0", "lo1", "lo2", "n1", "n2")
_SCALAR_FIELDS = ("dt", "dt_eps", "slot_s")


_FLEET_SIZE_FIELDS = ("D", "K", "U", "J", "Q", "NE", "i0", "n_steps")


class _FleetArgs(ctypes.Structure):
    """Mirror of ``struct FleetArgs`` in ``csrc/fleet_fused.cu``."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in _FLEET_CFG_FIELDS]
        + [(f, ctypes.c_void_p) for f in DeviceCarry._fields]
        + [("in_" + f, ctypes.c_void_p) for f in DeviceCarry._fields]
        + [(f, ctypes.c_int) for f in _FLEET_SIZE_FIELDS]
        + [(f, ctypes.c_float) for f in _SCALAR_FIELDS]
    )


class _ServeArgs(ctypes.Structure):
    """Mirror of ``struct ServeArgs`` in ``csrc/serve_fused.cu``."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in _CFG_FIELDS]
        + [(f, ctypes.c_void_p) for f in DeviceCarry._fields]
        + [("in_" + f, ctypes.c_void_p) for f in DeviceCarry._fields]
        + [(f, ctypes.c_void_p) for f in _TABLE_FIELDS]
        + [("log_" + f, ctypes.c_void_p) for f in ServeLog._fields]
        + [(f, ctypes.c_int) for f in _SIZE_FIELDS + _PLAN_FIELDS]
        + [(f, ctypes.c_float) for f in _SCALAR_FIELDS]
    )


def _expect(name, t, shape, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_step_state(kernel: str, cfg: StepParams, dev: DeviceCarry,
                      fields, Q: int):
    """Check the config fields a kernel reads and every carry leaf against
    the shapes and dtypes the CUDA source expects."""
    D, K = cfg.period.shape
    U = cfg.unit_time.shape[-1]
    J = cfg.margins.shape[-2]
    NE = cfg.events.shape[-1]
    if Q > QMAX or K > KMAX:
        raise ValueError(f"{kernel}: Q={Q}, K={K} exceed the kernel's caps "
                         f"Q<={QMAX}, K<={KMAX}")
    dev0 = cfg.policy.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    cfg_spec = dict(
        policy=((D,), i32), imprecise=((D,), b8), is_edfm=((D,), b8),
        eta=((D,), f32), alpha=((D,), f32), beta=((D,), f32),
        persistent=((D,), b8), capacity=((D,), f32), e_man=((D,), f32),
        e_opt=((D,), f32), power_on=((D,), f32), clock_drift=((D,), f32),
        use_exit_thr=((D,), b8), exit_thr=((D, K, U), f32),
        period=((D, K), f32), rel_deadline=((D, K), f32),
        fragments=((D, K), f32), n_units=((D, K), i32),
        n_releases=((D, K), i32), unit_time=((D, K, U), f32),
        unit_energy=((D, K, U), f32), events=((D, NE), f32),
        margins=((D, K, J, U), f32), passes=((D, K, J, U), b8),
        correct=((D, K, J, U), b8))
    for f in fields:
        _expect(f"{kernel}: cfg.{f}", getattr(cfg, f), *cfg_spec[f], dev0)
    for f in DeviceCarry._fields:
        q_or_k = (Q,) if f.startswith("q_") else (
            (K,) if f in ("next_rel", "m_scheduled", "m_correct",
                          "m_misses", "m_units", "m_optional") else ())
        dt_ = (b8 if f in ("was_off", "q_active", "q_correct", "q_apass")
               else f32 if f in ("energy", "q_release", "q_deadline",
                                 "q_time_left", "q_mand_time", "q_margin",
                                 "m_busy", "m_idle", "m_wasted")
               else i32)
        _expect(f"{kernel}: dev.{f}", getattr(dev, f), (D,) + q_or_k, dt_,
                dev0)
    return D, K, U, J, NE


def _load(name: str, size_fn: str, struct) -> ctypes.CDLL:
    lib = _build.load(name)
    size = getattr(lib, size_fn)
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(struct):
        raise RuntimeError(f"{name}: the {struct.__name__[1:]} layout "
                           f"differs between csrc/{name}.cu and this wrapper")
    return lib


def _cfg_bytes(cfg: StepParams) -> int:
    return sum(_cost.nbytes(getattr(cfg, f)) for f in _CFG_FIELDS)


def fleet_work(D: int, Q: int, n_steps: int, cfg_bytes: int,
               carry_bytes: int, units: int = 0) -> _cost.Work:
    """One call of kernel B: the config's ``cfg_bytes`` once, the carry
    in and out, and per completed unit the margin, pass and correctness
    entries it reads (6 bytes); ~40 operations per queue slot of each
    device-step (scores, energy gates, admission)."""
    return _cost.Work(bytes=cfg_bytes + 2 * carry_bytes + 6 * units,
                      ops=40.0 * D * n_steps * Q)


def serve_work(D: int, Q: int, n_steps: int, cfg_bytes: int,
               carry_bytes: int, S: int, C: int,
               units: int = 0) -> _cost.Work:
    """One call of kernel C: as :func:`fleet_work` for the step (the
    carry is the device carry and the log), and per completed unit its
    ``S`` selected features, feature indices and ``C x S`` centroids read
    and its log entries written, with the ``C x S`` L1 distances (3
    operations an element)."""
    return _cost.Work(
        bytes=cfg_bytes + 2 * carry_bytes
        + units * (4 * (2 * S + C * S) + 4 * (C + 2)),
        ops=40.0 * D * n_steps * Q + units * 3.0 * C * S)


def _units(new: DeviceCarry, old: DeviceCarry) -> int:
    """Units completed between two carries (0 on ``meta``)."""
    if new.m_units.device.type == "meta":
        return 0
    return int((new.m_units.to(torch.int64) - old.m_units).sum())


def _fleet_call_work(cfg, carry, i0, *, result, statics, n_steps):
    return fleet_work(cfg.policy.shape[0], statics.queue_size, n_steps,
                      _cfg_bytes(cfg), _cost.nbytes(*carry),
                      _units(result, carry))


def _serve_call_work(cfg, carry, tables, i0, job0, *, result, statics,
                     n_steps):
    return serve_work(cfg.policy.shape[0], statics.queue_size, n_steps,
                      _cfg_bytes(cfg),
                      _cost.nbytes(*carry.dev) + _cost.nbytes(*carry.log),
                      tables.fidx.shape[-1], carry.bank.centroids.shape[-2],
                      _units(result.dev, carry.dev))


def _fleet_launch(cfg: StepParams, carry: DeviceCarry, i0: int, *, statics,
                  n_steps: int) -> DeviceCarry:
    global fleet_launches
    dev0 = cfg.policy.device
    Q = statics.queue_size
    D, K, U, J, NE = _check_step_state("fleet_fused_steps", cfg, carry,
                                       _FLEET_CFG_FIELDS, Q)
    if D == 0 or n_steps <= 0:
        return DeviceCarry(*[l.clone() for l in carry])
    # the kernel writes every element of every leaf of the new carry
    dev = DeviceCarry(*[torch.empty_like(l) for l in carry])
    args = _FleetArgs()
    for f in _FLEET_CFG_FIELDS:
        setattr(args, f, getattr(cfg, f).data_ptr())
    for f in DeviceCarry._fields:
        setattr(args, f, getattr(dev, f).data_ptr())
        setattr(args, "in_" + f, getattr(carry, f).data_ptr())
    sizes = dict(D=D, K=K, U=U, J=J, Q=Q, NE=NE, i0=int(i0),
                 n_steps=int(n_steps))
    for f in _FLEET_SIZE_FIELDS:
        setattr(args, f, sizes[f])
    args.dt = statics.dt
    args.dt_eps = statics.dt_eps
    args.slot_s = statics.slot_s
    err = _fleet_kernel()(ctypes.byref(args), _build.stream_handle(dev0))
    _build.check(err, "fleet_fused_steps")
    fleet_launches += 1
    return dev


_FLEET_FN = {}


def _fleet_kernel():
    """Kernel B's launch function, bound once."""
    if "launch" not in _FLEET_FN:
        lib = _load("fleet_fused", "fleet_args_size", _FleetArgs)
        fn = lib.fleet_fused_launch
        fn.argtypes = [ctypes.POINTER(_FleetArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FLEET_FN["launch"] = fn
    return _FLEET_FN["launch"]


@_cost.counted("fleet_fused_steps", _fleet_call_work)
def fleet_fused_steps(cfg: StepParams, carry: DeviceCarry, i0: int, *,
                      statics, n_steps: int) -> DeviceCarry:
    """Advance the replay fleet ``n_steps`` timesteps from step ``i0``:
    same carry in, same carry out as ``n_steps`` calls of the replay
    ``device_step``.  Every leaf carries a leading ``D`` axis.  CPU tensors
    take the plain version; CUDA tensors launch the kernel ONCE for the
    whole segment."""
    dev = cfg.policy.device
    if dev.type == "cpu":
        return fleet_fused_steps_plain(cfg, carry, i0, statics=statics,
                                       n_steps=n_steps)
    if dev.type != "cuda":
        raise ValueError(f"fleet_fused_steps: unsupported device {dev}")
    return _fleet_launch(cfg, carry, i0, statics=statics, n_steps=n_steps)


def _serve_launch(cfg: StepParams, carry: ServeCarry, tables, i0: int, job0,
            *, statics, n_steps: int) -> ServeCarry:
    global serve_launches
    dev0 = cfg.policy.device
    shared_bank = carry.bank.centroids.dim() == 4
    per_dev_tables = tables.sel_feats.dim() == 5
    Q = statics.queue_size
    D, K, U, _, NE = _check_step_state("serve_fused_steps", cfg, carry.dev,
                                       _CFG_FIELDS, Q)
    W = tables.labels.shape[-1]
    C, F = carry.bank.centroids.shape[-2:]
    S_ = tables.fidx.shape[-1]
    if S_ > _MAX_S:
        raise ValueError(f"serve_fused_steps: S={S_} exceeds {_MAX_S}")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    bank_lead = () if shared_bank else (D,)
    tab_lead = (D,) if per_dev_tables else ()
    _expect("serve_fused_steps: bank.centroids", carry.bank.centroids,
            bank_lead + (K, U, C, F), f32, dev0)
    _expect("serve_fused_steps: tables.sel_feats", tables.sel_feats,
            tab_lead + (K, W, U, S_), f32, dev0)
    for name, t, shape, dtype in (
            ("labels", tables.labels, tab_lead + (K, W), i32),
            ("clabels", tables.clabels, (K, U, C), i32),
            ("fidx", tables.fidx, (K, U, S_), i32),
            ("thr", tables.thr, (K, U), f32)):
        _expect(f"serve_fused_steps: tables.{name}", t, shape, dtype, dev0)
    _expect("serve_fused_steps: job0", job0, (K,), i32, dev0)
    log_dt = dict(units=i32, pred=i32, correct=b8, margin=f32,
                  exit_unit=i32, sched=b8)
    for f in ServeLog._fields:
        _expect(f"serve_fused_steps: log.{f}", getattr(carry.log, f),
                (D, K, W), log_dt[f], dev0)

    if D == 0 or n_steps <= 0:
        return ServeCarry(dev=DeviceCarry(*[l.clone() for l in carry.dev]),
                          bank=carry.bank,
                          log=ServeLog(*[l.clone() for l in carry.log]))
    # the kernel writes every element of every leaf of the new carry and
    # updates the log's clone in place
    dev = DeviceCarry(*[torch.empty_like(l) for l in carry.dev])
    log = ServeLog(*[l.clone() for l in carry.log])
    args = _ServeArgs()
    for f in _CFG_FIELDS:
        setattr(args, f, getattr(cfg, f).data_ptr())
    for f in DeviceCarry._fields:
        setattr(args, f, getattr(dev, f).data_ptr())
        setattr(args, "in_" + f, getattr(carry.dev, f).data_ptr())
    args.centroids = carry.bank.centroids.data_ptr()
    args.sel_feats = tables.sel_feats.data_ptr()
    args.labels = tables.labels.data_ptr()
    args.clabels = tables.clabels.data_ptr()
    args.fidx = tables.fidx.data_ptr()
    args.thr = tables.thr.data_ptr()
    args.job0 = job0.data_ptr()
    for f in ServeLog._fields:
        setattr(args, "log_" + f, getattr(log, f).data_ptr())
    sizes = dict(D=D, K=K, U=U, Q=Q, W=W, C=C, F=F, S=S_, NE=NE,
                 shared_bank=int(shared_bank),
                 per_dev_tables=int(per_dev_tables), i0=int(i0),
                 n_steps=int(n_steps))
    sizes.update(zip(_PLAN_FIELDS, window_plan(S_)))
    for f in _SIZE_FIELDS + _PLAN_FIELDS:
        setattr(args, f, sizes[f])
    args.dt = statics.dt
    args.dt_eps = statics.dt_eps
    args.slot_s = statics.slot_s
    err = _serve_kernel()(ctypes.byref(args), _build.stream_handle(dev0))
    _build.check(err, "serve_fused_steps")
    serve_launches += 1
    return ServeCarry(dev=dev, bank=carry.bank, log=log)


_SERVE_FN = {}


def _serve_kernel():
    """Kernel C's launch function, bound once."""
    if "launch" not in _SERVE_FN:
        lib = _load("serve_fused", "serve_args_size", _ServeArgs)
        fn = lib.serve_fused_launch
        fn.argtypes = [ctypes.POINTER(_ServeArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SERVE_FN["launch"] = fn
    return _SERVE_FN["launch"]


@_cost.counted("serve_fused_steps", _serve_call_work)
def serve_fused_steps(cfg: StepParams, carry: ServeCarry, tables, i0: int,
                      job0: torch.Tensor, *, statics, n_steps: int
                      ) -> ServeCarry:
    """Advance live serving ``n_steps`` timesteps from step ``i0``.

    ``cfg``/``carry.dev``/``carry.log`` leaves carry a leading ``D`` axis;
    the bank does too unless it is shared (4-D centroids); the
    feature/label tables do with per-device request streams (5-D
    ``sel_feats``).  CPU tensors take the plain version; CUDA
    tensors launch the kernel ONCE for the whole segment."""
    dev = cfg.policy.device
    if dev.type == "cpu":
        return serve_fused_steps_plain(cfg, carry, tables, i0, job0,
                                       statics=statics, n_steps=n_steps)
    if dev.type != "cuda":
        raise ValueError(f"serve_fused_steps: unsupported device {dev}")
    return _serve_launch(cfg, carry, tables, i0, job0, statics=statics,
                         n_steps=n_steps)
