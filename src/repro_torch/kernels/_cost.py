"""The kernels' work and the sink that records it.

Each kernel module has a ``work(...)`` function: given one call's shapes,
dtypes and flags it returns a :class:`Work`, the call's useful operations
(and the peak they run at) and the HBM bytes it must move, each input read
once and each output written once.  These are the bytes and operations of
the bound that ``chip_smoke.py`` and ``tools/kernel_device_times.py``
print for every kernel, and the cost the op counter
(:mod:`repro_torch.launch.op_cost`) gives a kernel call.

Every public entry point is wrapped by :func:`counted`.  With no counter
active the wrapper costs one ``is None`` test.  With one active, the call
runs with the counter muted (the plain version's ops, the CUDA wrapper's
allocations and casts, the ``meta`` branch's empty outputs: none of them
counted) and then counts as one item of its kernel's :class:`Work`, so a
kernel call has the same cost on the card, on the CPU and on ``meta``.
Work that depends on the data (E's assigned rows, H's kept slots, B's and
C's completed units) is read from the tensors when they hold data (a host
read, only while counting) and taken at its most on ``meta``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass


@dataclass(frozen=True)
class Work:
    """One call's useful work: ``ops`` at the peak of ``dtype``
    (``"bf16"``: the tensor cores; ``"f32"``: the CUDA cores), ``bytes``
    of HBM traffic; ``dot`` marks products (counted in ``dot_flops``)."""

    bytes: float
    ops: float
    dtype: str = "f32"
    dot: bool = False


#: the active op counter (:class:`repro_torch.launch.op_cost.Counter`), or
#: None; set by the counter on entry and restored on exit
sink = None


def nbytes(*tensors) -> int:
    """Bytes of ``tensors`` as stored (numel x element size)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def counted(name: str, work_of):
    """Wrap a public entry point: while a counter is active, the call runs
    muted and then counts as one item ``name`` of ``work_of(*args,
    result=<the call's result>, **kwargs)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            s = sink
            if s is None:
                return fn(*args, **kwargs)
            s.mute += 1
            try:
                out = fn(*args, **kwargs)
                work = work_of(*args, result=out, **kwargs)
            finally:
                s.mute -= 1
            s.note(name, work)
            return out

        return entry

    return wrap
