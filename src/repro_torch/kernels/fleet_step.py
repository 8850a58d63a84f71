"""Fused live serving: a whole segment of ``serve_step`` in ONE launch.

Replaces the Pallas TPU kernel ``repro/kernels/fleet_step.py:
serve_fused_steps``.  Per device and per step it runs admit -> drop-expired
-> pick -> classify the completing unit against the centroid bank (the
shared L1 top-2 of ``csrc/l1_topk2.cuh``) -> apply -> latch the utility
pass -> write the outcome log, exactly as
:func:`repro_torch.serve.fleet_engine.serve_step` does.  The CUDA kernel
(``csrc/serve_fused.cu``) runs one thread per device with the queue and
task registers in local arrays; what bounds it and why is noted there.

Like the reference it takes ``adapt=False`` only: bank adaptation
propagates centroids through whole-model convolutions.  The bank passes
through unchanged.  Booleans stay ``torch.bool`` (one byte); the int32
packing of the reference exists for the TPU compiler only.

The wrapper clones the device carry and the outcome log, and the kernel
updates the clone in place: the caller's carry is never written.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.step import DeviceCarry, StepParams
from ..fleet.state import ServeCarry, ServeLog
from . import _build

#: compile-time caps of the kernel's local arrays (csrc/serve_fused.cu)
QMAX = 8
KMAX = 8
_MAX_S = 32 ** 4      # the shared OrderedSum tracks at most 3 window levels
_THREADS = 128

#: launches of the CUDA kernel (the plain version never counts)
launches = 0


def serve_fused_steps_plain(cfg, carry, tables, i0, job0, *, statics,
                            n_steps):
    """The plain version: ``n_steps`` calls of the batch-polymorphic
    ``serve_step`` (bank untouched)."""
    from ..serve.fleet_engine import serve_step

    dev, bank, log = carry
    for i in range(i0, i0 + n_steps):
        t = step_time(i, statics.dt, cfg.policy.device)
        dev, log, _ = serve_step(cfg, tables, dev, bank, log, t, job0,
                                 statics=statics)
    return ServeCarry(dev=dev, bank=bank, log=log)


def step_time(i: int, dt: float, device) -> torch.Tensor:
    """The shared clock ``t = f32(i) * f32(dt)`` as an f32 0-d tensor: one
    IEEE f32 product (formed on the host), the same the kernel forms."""
    t = np.float32(i) * np.float32(dt)
    return torch.full((), float(t), dtype=torch.float32, device=device)


# --------------------------------------------------------------------- #
# The CUDA launch.
# --------------------------------------------------------------------- #

_CFG_FIELDS = ("policy", "imprecise", "is_edfm", "eta", "alpha", "beta",
               "persistent", "capacity", "e_man", "e_opt", "power_on",
               "clock_drift", "use_exit_thr", "exit_thr", "period",
               "rel_deadline", "fragments", "n_units", "n_releases",
               "unit_time", "unit_energy", "events")
_TABLE_FIELDS = ("centroids", "sel_feats", "labels", "clabels", "fidx",
                 "thr", "job0")
_SIZE_FIELDS = ("D", "K", "U", "Q", "W", "C", "F", "S", "NE",
                "shared_bank", "per_dev_tables", "i0", "n_steps")
_SCALAR_FIELDS = ("dt", "dt_eps", "slot_s")


class _ServeArgs(ctypes.Structure):
    """Mirror of ``struct ServeArgs`` in ``csrc/serve_fused.cu``."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in _CFG_FIELDS]
        + [(f, ctypes.c_void_p) for f in DeviceCarry._fields]
        + [(f, ctypes.c_void_p) for f in _TABLE_FIELDS]
        + [("log_" + f, ctypes.c_void_p) for f in ServeLog._fields]
        + [(f, ctypes.c_int) for f in _SIZE_FIELDS]
        + [(f, ctypes.c_float) for f in _SCALAR_FIELDS]
    )


def _expect(name, t, shape, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"serve_fused_steps: {name} is {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"serve_fused_steps: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"serve_fused_steps: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"serve_fused_steps: {name} is not contiguous")


def _launch(cfg: StepParams, carry: ServeCarry, tables, i0: int, job0,
            *, statics, n_steps: int) -> ServeCarry:
    global launches
    dev0 = cfg.policy.device
    shared_bank = carry.bank.centroids.dim() == 4
    per_dev_tables = tables.sel_feats.dim() == 5
    D, K = cfg.period.shape
    U = cfg.unit_time.shape[-1]
    Q = statics.queue_size
    W = tables.labels.shape[-1]
    C, F = carry.bank.centroids.shape[-2:]
    S = tables.fidx.shape[-1]
    NE = cfg.events.shape[-1]
    if Q > QMAX or K > KMAX:
        raise ValueError(f"serve_fused_steps: Q={Q}, K={K} exceed the "
                         f"kernel's caps Q<={QMAX}, K<={KMAX}")
    if S > _MAX_S:
        raise ValueError(f"serve_fused_steps: S={S} exceeds {_MAX_S}")
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
        unit_energy=((D, K, U), f32), events=((D, NE), f32))
    for f in _CFG_FIELDS:
        _expect(f"cfg.{f}", getattr(cfg, f), *cfg_spec[f], dev0)
    dev_spec = {}
    for f in DeviceCarry._fields:
        q_or_k = (Q,) if f.startswith("q_") else (
            (K,) if f in ("next_rel", "m_scheduled", "m_correct",
                          "m_misses", "m_units", "m_optional") else ())
        dt_ = (b8 if f in ("was_off", "q_active", "q_correct", "q_apass")
               else f32 if f in ("energy", "q_release", "q_deadline",
                                 "q_time_left", "q_mand_time", "q_margin",
                                 "m_busy", "m_idle", "m_wasted")
               else i32)
        dev_spec[f] = ((D,) + q_or_k, dt_)
        _expect(f"dev.{f}", getattr(carry.dev, f), *dev_spec[f], dev0)
    bank_lead = () if shared_bank else (D,)
    tab_lead = (D,) if per_dev_tables else ()
    _expect("bank.centroids", carry.bank.centroids,
            bank_lead + (K, U, C, F), f32, dev0)
    _expect("tables.sel_feats", tables.sel_feats,
            tab_lead + (K, W, U, S), f32, dev0)
    _expect("tables.labels", tables.labels, tab_lead + (K, W), i32, dev0)
    _expect("tables.clabels", tables.clabels, (K, U, C), i32, dev0)
    _expect("tables.fidx", tables.fidx, (K, U, S), i32, dev0)
    _expect("tables.thr", tables.thr, (K, U), f32, dev0)
    _expect("job0", job0, (K,), i32, dev0)
    log_dt = dict(units=i32, pred=i32, correct=b8, margin=f32,
                  exit_unit=i32, sched=b8)
    for f in ServeLog._fields:
        _expect(f"log.{f}", getattr(carry.log, f), (D, K, W), log_dt[f],
                dev0)

    # the kernel updates these clones in place
    dev = DeviceCarry(*[l.clone() for l in carry.dev])
    log = ServeLog(*[l.clone() for l in carry.log])
    args = _ServeArgs()
    for f in _CFG_FIELDS:
        setattr(args, f, getattr(cfg, f).data_ptr())
    for f in DeviceCarry._fields:
        setattr(args, f, getattr(dev, f).data_ptr())
    args.centroids = carry.bank.centroids.data_ptr()
    args.sel_feats = tables.sel_feats.data_ptr()
    args.labels = tables.labels.data_ptr()
    args.clabels = tables.clabels.data_ptr()
    args.fidx = tables.fidx.data_ptr()
    args.thr = tables.thr.data_ptr()
    args.job0 = job0.data_ptr()
    for f in ServeLog._fields:
        setattr(args, "log_" + f, getattr(log, f).data_ptr())
    sizes = dict(D=D, K=K, U=U, Q=Q, W=W, C=C, F=F, S=S, NE=NE,
                 shared_bank=int(shared_bank),
                 per_dev_tables=int(per_dev_tables), i0=int(i0),
                 n_steps=int(n_steps))
    for f in _SIZE_FIELDS:
        setattr(args, f, sizes[f])
    args.dt = statics.dt
    args.dt_eps = statics.dt_eps
    args.slot_s = statics.slot_s

    lib = _build.load("serve_fused")
    lib.serve_args_size.restype = ctypes.c_int
    if lib.serve_args_size() != ctypes.sizeof(_ServeArgs):
        raise RuntimeError("serve_fused_steps: ServeArgs layout differs "
                           "between csrc/serve_fused.cu and this wrapper")
    fn = lib.serve_fused_launch
    fn.argtypes = [ctypes.POINTER(_ServeArgs), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if D > 0 and n_steps > 0:
        err = fn(ctypes.byref(args), _THREADS, _build.stream_handle(dev0))
        _build.check(err, "serve_fused_steps")
        launches += 1
    return ServeCarry(dev=dev, bank=carry.bank, log=log)



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
    return _launch(cfg, carry, tables, i0, job0, statics=statics,
                   n_steps=n_steps)
