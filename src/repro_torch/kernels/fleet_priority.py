"""The fleet simulator's per-step pick: priority scores, argmax, energy gate
and capacitor update for every device in ONE launch.

Replaces the Pallas TPU kernel ``repro/kernels/fleet_priority.py:
fleet_priority``.  Per device it scores the Q queue slots under the
device's policy (:func:`repro_torch.core.policy.policy_scores`) with the
round-robin rank ``(task - cursor) mod K``, then applies
:func:`repro_torch.core.step.select_and_charge`: the forced (locked) slot,
the threshold test, the energy gate and the capacitor charge/discharge.
The per-slot ingredients (laxity, utility, gate energy, drain) come from
the plain :func:`repro_torch.core.step.pick_inputs`, as the reference
leaves its table gathers outside the kernel too.

The CUDA kernel (``csrc/fleet_priority.cu``) runs one thread per device
with the slots in registers; what bounds it and why is noted there.
Booleans stay ``torch.bool`` (one byte).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import policy as P
from ..core import step as S
from . import _build

#: compile-time cap of the kernel's slot registers (csrc/device_step.cuh)
QMAX = 8
_THREADS = 128

#: launches of the CUDA kernel (the plain version never counts)
launches = 0

_IN_VEC = ("policy", "alpha", "beta", "eta", "persistent", "energy",
           "e_opt", "power", "capacity", "forced", "rr_cursor")
_IN_ROW = ("active", "laxity", "release", "utility", "mandatory", "gate_e",
           "drain", "task")
_OUT = ("sel", "picked", "run", "e_new")
_DTYPES = dict(policy=torch.int32, persistent=torch.bool,
               forced=torch.int32, rr_cursor=torch.int32,
               active=torch.bool, mandatory=torch.bool, task=torch.int32,
               sel=torch.int32, picked=torch.bool, run=torch.bool)


def fleet_priority_plain(policy, active, laxity, release, utility, mandatory,
                         alpha, beta, eta, persistent, energy, e_opt, power,
                         capacity, gate_e, drain, forced, task, rr_cursor, *,
                         n_tasks: int, dt: float):
    """The plain version: policy scores with the round-robin rank, then
    the step core's selection and capacitor update."""
    task_rank = torch.remainder(task - rr_cursor[:, None],
                                n_tasks).to(torch.float32)
    scores, thr = P.policy_scores(
        policy[:, None], active, laxity, release, utility, mandatory,
        alpha[:, None], beta[:, None], eta[:, None], energy[:, None],
        e_opt[:, None], persistent[:, None], task_rank)
    return S.select_and_charge(scores, thr[:, 0], forced, energy, power,
                               capacity, gate_e, drain, dt)


class _PriorityArgs(ctypes.Structure):
    """Mirror of ``struct PriorityArgs`` in ``csrc/fleet_priority.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _IN_VEC + _IN_ROW + _OUT]
                + [("D", ctypes.c_int), ("Q", ctypes.c_int),
                   ("n_tasks", ctypes.c_int), ("dt", ctypes.c_float)])


def _launch(ins: dict, *, n_tasks: int, dt: float):
    global launches
    dev = ins["policy"].device
    D, Q = ins["active"].shape
    if Q > QMAX:
        raise ValueError(f"fleet_priority: Q={Q} exceeds the kernel's cap "
                         f"Q<={QMAX}")
    args = _PriorityArgs()
    keep = []
    for f in _IN_VEC + _IN_ROW:
        t = ins[f]
        want = _DTYPES.get(f, torch.float32)
        shape = (D,) if f in _IN_VEC else (D, Q)
        if t.dtype != want or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"fleet_priority: {f} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{want} {shape} on {dev}")
        t = t.contiguous()
        keep.append(t)
        setattr(args, f, t.data_ptr())
    outs = {f: torch.empty(D, dtype=_DTYPES.get(f, torch.float32),
                           device=dev) for f in _OUT}
    for f in _OUT:
        setattr(args, f, outs[f].data_ptr())
    args.D, args.Q, args.n_tasks, args.dt = D, Q, n_tasks, dt

    lib = _build.load("fleet_priority")
    lib.priority_args_size.restype = ctypes.c_int
    if lib.priority_args_size() != ctypes.sizeof(_PriorityArgs):
        raise RuntimeError("fleet_priority: PriorityArgs layout differs "
                           "between csrc/fleet_priority.cu and this wrapper")
    fn = lib.fleet_priority_launch
    fn.argtypes = [ctypes.POINTER(_PriorityArgs), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if D > 0:
        err = fn(ctypes.byref(args), _THREADS, _build.stream_handle(dev))
        _build.check(err, "fleet_priority")
        launches += 1
    return tuple(outs[f] for f in _OUT)


def fleet_priority(policy, active, laxity, release, utility, mandatory,
                   alpha, beta, eta, persistent, energy, e_opt, power,
                   capacity, gate_e, drain, forced, task, rr_cursor, *,
                   n_tasks: int, dt: float):
    """Batched pick + capacitor update: ``(D,)`` per-device and ``(D, Q)``
    per-slot operands -> ``(sel int32, picked bool, run bool, e_new f32)``,
    each ``(D,)``.  ``power`` is the harvested power; the charge ``power *
    dt`` joins the capacitor update as one rounding.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    dev = policy.device
    ins = dict(zip(_IN_VEC, (policy, alpha, beta, eta, persistent, energy,
                             e_opt, power, capacity, forced, rr_cursor)))
    ins.update(zip(_IN_ROW, (active, laxity, release, utility, mandatory,
                             gate_e, drain, task)))
    if dev.type == "cpu":
        return fleet_priority_plain(**ins, n_tasks=n_tasks, dt=dt)
    if dev.type != "cuda":
        raise ValueError(f"fleet_priority: unsupported device {dev}")
    return _launch(ins, n_tasks=n_tasks, dt=dt)
