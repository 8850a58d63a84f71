"""Architecture registry (port of :mod:`repro.configs`).

Every registered architecture has one module here, copied from the
reference; ``get_config(name)`` resolves every name the JAX registry does.
"""
from __future__ import annotations

import importlib

from .base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    list_configs,
    register,
)

_ARCH_MODULES = (
    "dbrx_132b",
    "minitron_8b",
    "qwen3_moe_235b_a22b",
    "recurrentgemma_9b",
    "internvl2_2b",
    "stablelm_3b",
    "xlstm_125m",
    "glm4_9b",
    "qwen1_5_0_5b",
    "seamless_m4t_medium",
    "paper_cnns",
)

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for mod in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{mod}")


# canonical --arch ids (the registry also contains the 4 paper CNNs)
ASSIGNED_ARCHS = (
    "dbrx-132b",
    "minitron-8b",
    "qwen3-moe-235b-a22b",
    "recurrentgemma-9b",
    "internvl2-2b",
    "stablelm-3b",
    "xlstm-125m",
    "glm4-9b",
    "qwen1.5-0.5b",
    "seamless-m4t-medium",
)
