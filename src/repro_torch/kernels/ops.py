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
from . import decode_gqa as _dg
from . import flash_attn as _fa
from . import fleet_priority as _fp
from . import fleet_step as _fs
from . import l1_topk2 as _l1
from . import pairwise_l1 as _pw
from . import rglru_scan as _rg
from .centroid_update import (  # noqa: F401
    centroid_finish,
    centroid_partial,
    centroid_update,
)
from .decode_gqa import (  # noqa: F401
    decode_gqa,
    decode_gqa_merge,
    decode_gqa_pv,
    decode_gqa_stats,
)
from .flash_attn import flash_attention, flash_attention_bwd  # noqa: F401
from .fleet_priority import fleet_priority  # noqa: F401
from .fleet_step import fleet_fused_steps, serve_fused_steps  # noqa: F401
from .l1_topk2 import l1_topk2  # noqa: F401
from .pairwise_l1 import pairwise_l1  # noqa: F401
from .rglru_scan import rglru_scan, rglru_scan_bwd  # noqa: F401

#: kernel name -> (module, name of its launch counter)
_MODULES = {"fleet_priority": (_fp, "launches"),
            "fleet_fused_steps": (_fs, "fleet_launches"),
            "serve_fused_steps": (_fs, "serve_launches"),
            "l1_topk2": (_l1, "launches"),
            "centroid_update": (_cu, "launches"),
            "centroid_partial": (_cu, "partial_launches"),
            "centroid_finish": (_cu, "finish_launches"),
            "pairwise_l1": (_pw, "launches"),
            "flash_attention": (_fa, "launches"),
            "decode_gqa": (_dg, "launches"),
            "decode_gqa_stats": (_dg, "stats_launches"),
            "decode_gqa_merge": (_dg, "merge_launches"),
            "decode_gqa_pv": (_dg, "pv_launches"),
            "rglru_scan": (_rg, "launches"),
            "flash_attention_bwd": (_fa, "bwd_launches"),
            "rglru_scan_bwd": (_rg, "bwd_launches")}


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last reset."""
    return {name: getattr(m, attr) for name, (m, attr) in _MODULES.items()}


def reset_launch_counts() -> None:
    for m, attr in _MODULES.values():
        setattr(m, attr, 0)
