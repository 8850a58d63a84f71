"""Public entry points of the port's kernels (port of
:mod:`repro.kernels.ops`).

Dispatch follows the tensor's device and nothing else: a CUDA tensor
launches the hand-written CUDA kernel (built from ``csrc/`` at first use)
or raises; a CPU tensor runs the kernel's plain PyTorch version.  There is
no fallback and no environment switch.

Each kernel keeps a plain-integer count of its CUDA launches;
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes
them, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from . import centroid_update as _cu
from . import fleet_step as _fs
from . import l1_topk2 as _l1
from .centroid_update import centroid_update  # noqa: F401
from .fleet_step import serve_fused_steps  # noqa: F401
from .l1_topk2 import l1_topk2  # noqa: F401

_MODULES = {"l1_topk2": _l1, "centroid_update": _cu,
            "serve_fused_steps": _fs}


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last reset."""
    return {name: m.launches for name, m in _MODULES.items()}


def reset_launch_counts() -> None:
    for m in _MODULES.values():
        m.launches = 0
