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

The launch path.  The kernel's device time is about the floor of any
launch (a few microseconds at the replay sweep's 1,600 devices), and the
main path calls it once per replay step, so what a call costs is this
wrapper's host work; the kernel's body is not the lever.  The wrapper
binds the library function and checks the argument layout once; checks
the 19 operands against the signature it expects with one compare of their
dtypes and one of their shapes (one device for all, all contiguous) and
runs the checks field by field, with their messages, only on a mismatch;
allocates the four outputs as views of one buffer; packs the pointers with
one ``struct.pack``; and reads the raw current stream
(``_build.stream_handle``).  ``PERF.md`` §6 has each step's time on
the card beside what it replaced.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from operator import attrgetter

import torch

from ..core import policy as P
from ..core import step as S
from . import _build, _cost

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
_ACTIVE = len(_IN_VEC)     # the operand whose shape is (D, Q)


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


#: the same layout as one ``struct.pack`` format: 23 pointers, 3 ints, 1 f32
_PACK = struct.Struct(f"{len(_IN_VEC + _IN_ROW + _OUT)}P3if")
#: the dtype of every operand, in the kernel's order
_DTYPE_SIG = tuple(_DTYPES.get(f, torch.float32) for f in _IN_VEC + _IN_ROW)
_dtype = attrgetter("dtype")
_shape = attrgetter("shape")
_get_device = torch.Tensor.get_device
_is_contiguous = torch.Tensor.is_contiguous
_data_ptr = torch.Tensor.data_ptr
_FN = {}


def _kernel():
    """The launch function of the built library, bound once, after the
    argument layout is checked against this wrapper's."""
    fn = _FN.get("launch")
    if fn is None:
        lib = _build.load("fleet_priority")
        lib.priority_args_size.restype = ctypes.c_int
        if not (lib.priority_args_size() == ctypes.sizeof(_PriorityArgs)
                == _PACK.size):
            raise RuntimeError("fleet_priority: PriorityArgs layout differs "
                               "between csrc/fleet_priority.cu and this "
                               "wrapper")
        fn = lib.fleet_priority_launch
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["launch"] = fn
    return fn


@functools.lru_cache(maxsize=16)
def _shape_sig(D: int, Q: int) -> tuple:
    """The shape of every operand of a ``(D, Q)`` call, in the kernel's
    order."""
    return tuple(torch.Size((D,) if f in _IN_VEC else (D, Q))
                 for f in _IN_VEC + _IN_ROW)


def _checked(ins: tuple) -> tuple:
    """``ins`` as the kernel takes them.  One compare each of the dtypes
    and the shapes against the expected signature, one device for all,
    all contiguous; on a mismatch, each operand's check with its own
    message, and a contiguous copy of any strided one."""
    shapes = tuple(map(_shape, ins))
    active = shapes[_ACTIVE]
    if (len(active) == 2 and active[1] <= QMAX
            and tuple(map(_dtype, ins)) == _DTYPE_SIG
            and shapes == _shape_sig(*active)
            and len(set(map(_get_device, ins))) == 1
            and all(map(_is_contiguous, ins))):
        return ins
    dev = ins[0].device
    D, Q = ins[_ACTIVE].shape
    if Q > QMAX:
        raise ValueError(f"fleet_priority: Q={Q} exceeds the kernel's cap "
                         f"Q<={QMAX}")
    out = []
    for f, t in zip(_IN_VEC + _IN_ROW, ins):
        want = _DTYPES.get(f, torch.float32)
        shape = (D,) if f in _IN_VEC else (D, Q)
        if t.dtype != want or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"fleet_priority: {f} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{want} {shape} on {dev}")
        out.append(t.contiguous())
    return tuple(out)


def _outputs(D: int, device) -> tuple:
    """``(sel int32, picked bool, run bool, e_new f32)``, each ``(D,)``:
    views of one allocation, the 4-byte outputs first for alignment."""
    sel, e_new, picked, run = torch.empty(
        10 * D, dtype=torch.uint8, device=device).split((4 * D, 4 * D, D, D))
    return (sel.view(torch.int32), picked.view(torch.bool),
            run.view(torch.bool), e_new.view(torch.float32))


def work(D: int, Q: int, in_bytes: int) -> _cost.Work:
    """One call: the ``in_bytes`` of the operands read once and the four
    ``(D,)`` outputs (10 bytes a device) written once; per slot the score's
    ~20 operations and the argmax compare, per device the rank, threshold,
    gate and capacitor update (~10)."""
    return _cost.Work(bytes=in_bytes + 10 * D, ops=float(D * (21 * Q + 10)))


def _call_work(*args, result, n_tasks, dt):
    D, Q = args[1].shape
    return work(D, Q, _cost.nbytes(*args))


def _launch(ins: tuple, *, n_tasks: int, dt: float):
    global launches
    ins = _checked(ins)
    dev = ins[0].device
    D, Q = ins[_ACTIVE].shape
    outs = _outputs(D, dev)
    if D > 0:
        args = _PACK.pack(*map(_data_ptr, ins), *map(_data_ptr, outs), D, Q,
                          n_tasks, dt)
        err = _kernel()(args, _THREADS, _build.stream_handle(dev))
        _build.check(err, "fleet_priority")
        launches += 1
    return outs


@_cost.counted("fleet_priority", _call_work)
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
    if dev.type == "cpu":
        return fleet_priority_plain(
            policy, active, laxity, release, utility, mandatory, alpha, beta,
            eta, persistent, energy, e_opt, power, capacity, gate_e, drain,
            forced, task, rr_cursor, n_tasks=n_tasks, dt=dt)
    if dev.type != "cuda":
        raise ValueError(f"fleet_priority: unsupported device {dev}")
    return _launch((policy, alpha, beta, eta, persistent, energy, e_opt,
                    power, capacity, forced, rr_cursor, active, laxity,
                    release, utility, mandatory, gate_e, drain, task),
                   n_tasks=n_tasks, dt=dt)
