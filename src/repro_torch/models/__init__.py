"""The model zoo (port of :mod:`repro.models`): the paper's agile CNNs, and
every family of the model configs (dense, MoE, the RG-LRU hybrid, xLSTM,
the encoder-decoder and the VLM), with the anytime (early-exit) view of
the latter.

    init_params(cfg, generator)            -> params dict
    forward(cfg, params, batch)            -> logits, aux
    prefill(cfg, params, batch)            -> logits, decode state
    decode_step(cfg, params, state, token) -> logits, decode state
"""
from . import (  # noqa: F401
    anytime, cnn, common, moe, rglru, transformer, xlstm)
from .transformer import (  # noqa: F401
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)
