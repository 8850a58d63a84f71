"""Profiling harness: first call split from steady state, trace capture,
roofline join (port of :mod:`repro.launch.profiling`).

* :func:`measure` times the first call apart from the steady state, then
  repeated calls each ending in ``torch.cuda.synchronize()`` on the
  arguments' card (the counterpart of ``block_until_ready``: kernel
  launches return before the card finishes).
* :func:`trace` is a ``torch.profiler`` context (CPU and CUDA activity)
  that writes a Chrome trace; a profiler that cannot start degrades to a
  notice.
* :func:`roofline_join` counts one further call with the op counter
  (:mod:`repro_torch.launch.op_cost`) and joins the measured steady time
  to the H100 roofline (:func:`repro_torch.launch.op_stats
  .roofline_terms`): the modelled flops and bytes, the bound and
  measured over bound.

Entry points run where their arguments live: on the card unless the
caller passes CPU tensors.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from .op_cost import Cost, count
from .op_stats import roofline_terms


@dataclass
class Measurement:
    """One profiled entry point: first call vs steady state, plus the
    optional roofline join (``roofline`` stays None unless requested;
    ``cost`` then holds the counted call for ``top_cost_items``)."""

    label: str
    compile_s: float             # the first call (see :func:`measure`)
    steady_s: float              # median per call, synchronised
    steady_min_s: float
    steady_max_s: float
    repeats: int
    roofline: Optional[dict] = None
    extra: dict = field(default_factory=dict)
    cost: Optional[Cost] = None

    def as_row(self) -> dict:
        """Flat JSON/CSV-friendly view."""
        row = dict(
            label=self.label,
            compile_s=round(self.compile_s, 4),
            steady_s=round(self.steady_s, 6),
            steady_min_s=round(self.steady_min_s, 6),
            steady_max_s=round(self.steady_max_s, 6),
            repeats=self.repeats,
        )
        if self.roofline is not None:
            row.update({f"roofline_{k}": v for k, v in self.roofline.items()})
        row.update({k: v for k, v in self.extra.items()
                    if not k.startswith("_")})
        return row


def _device(args, kwargs) -> torch.device:
    """The device of the first tensor among the arguments (the CPU if
    none)."""
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn, *args, label: str = "fn", repeats: int = 10,
            warmup: int = 2, **kwargs) -> Measurement:
    """Profile one callable: its first call timed apart, then ``warmup``
    throwaway and ``repeats`` timed calls, each ended by a synchronisation
    of the arguments' card.

    ``compile_s`` is the first call.  Eager PyTorch compiles nothing
    there; the call holds what a first call pays: loading the kernels'
    libraries (built by ``nvcc`` if not yet cached), cuBLAS and cuDNN
    set-up and the allocator's growth.  On a card ``extra`` holds
    ``peak_bytes``, the peak device memory above the first call's start
    over all the calls."""
    dev = _device(args, kwargs)
    if dev.type == "cuda":
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    meas = Measurement(
        label=label,
        compile_s=compile_s,
        steady_s=float(np.median(times)),
        steady_min_s=float(np.min(times)),
        steady_max_s=float(np.max(times)),
        repeats=repeats,
    )
    if dev.type == "cuda":
        meas.extra["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    meas.extra["_call"] = (fn, args, kwargs)   # for roofline_join
    return meas


def roofline_join(meas: Measurement, n_devices: int = 1) -> Measurement:
    """Attach the op-cost roofline to a :func:`measure` result: one more
    call, untimed, under the op counter; its flops (and products by type),
    bytes and collective bytes, the H100 bound, the dominant term and
    ``measured_over_bound``, how far the measured steady time sits above
    the model's best case."""
    call = meas.extra.pop("_call", None)
    if call is None:
        return meas
    fn, args, kwargs = call
    _, cost = count(fn, *args, n_devices=n_devices, **kwargs)
    _sync(_device(args, kwargs))
    terms = roofline_terms(flops=cost.flops, bytes_accessed=cost.bytes,
                           ici_bytes=cost.ici_bytes, tc_flops=cost.tc_flops)
    bound = terms["bound_s"]
    meas.cost = cost
    meas.roofline = dict(
        flops=cost.flops,
        dot_flops=cost.dot_flops,
        dot_flops_by_dtype=dict(cost.dot_flops_by_dtype),
        bytes=cost.bytes,
        ici_bytes=cost.ici_bytes,
        kernels=dict(cost.kernels),
        bound_s=bound,
        dominant=terms["dominant"],
        measured_over_bound=(meas.steady_s / bound if bound > 0 else None),
    )
    return meas


def profile_call(fn, *args, label: str = "fn", repeats: int = 10,
                 warmup: int = 2, n_devices: int = 1,
                 **kwargs) -> Measurement:
    """:func:`measure` + :func:`roofline_join` in one call."""
    meas = measure(fn, *args, label=label, repeats=repeats, warmup=warmup,
                   **kwargs)
    return roofline_join(meas, n_devices=n_devices)


@contextlib.contextmanager
def trace(log_dir, enabled: bool = True):
    """``torch.profiler`` context over CPU and (with a card) CUDA activity
    that writes ``<log_dir>/trace.json``, a Chrome trace (Perfetto
    loadable); yields its path.

    ``enabled=False`` makes it a clean no-op (yields None); a profiler
    that fails to start prints a notice and yields None."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.__enter__()
    except RuntimeError as e:
        print(f"# profiling: trace disabled ({e})")
        yield None
        return
    path = Path(log_dir) / "trace.json"
    try:
        yield str(path)
    finally:
        prof.__exit__(None, None, None)
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
