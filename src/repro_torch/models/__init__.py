"""The model zoo (port of :mod:`repro.models`): the paper's agile CNNs, and
the dense attention family and the RG-LRU hybrid of the model configs, with
the anytime (early-exit) view of the latter.

    init_params(cfg, generator)            -> params dict
    forward(cfg, params, batch)            -> logits, aux
    prefill(cfg, params, batch)            -> logits, decode state
    decode_step(cfg, params, state, token) -> logits, decode state
"""
from . import anytime, cnn, common, rglru, transformer  # noqa: F401
from .transformer import (  # noqa: F401
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)
