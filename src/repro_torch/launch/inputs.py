"""``input_specs()``: shape stand-ins for every model input (port of
:mod:`repro.launch.inputs`).

For a training or prefill step this is the token batch (plus the stubbed
modality-frontend embeddings of the VLM and audio architectures).  For a
decode step it is the one-token batch plus the whole decode state (KV
caches, recurrent states) sized for the shape's ``seq_len``.  The stand-ins
are tensors on the ``meta`` device with the reference's shapes and dtypes:
nothing here allocates memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs import INPUT_SHAPES, InputShape, ModelConfig
from ..models import transformer as tfm

_META = torch.device("meta")


class ShapeSkip(Exception):
    """Raised for the documented (arch, shape) skips."""


@dataclass(frozen=True)
class LoweringSpec:
    """Everything a step needs for one (arch, shape) combination."""

    cfg: ModelConfig
    shape: InputShape
    step_kind: str                 # "train" | "prefill" | "decode"
    window: Optional[int]          # attention-window override (long_500k)
    args: tuple                    # meta-tensor trees for the step


def resolve_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """long_500k needs sub-quadratic attention: native configs run as they
    are, dense ones take the sanctioned sliding-window override, ``skip``
    raises :class:`ShapeSkip`."""
    if shape.name != "long_500k":
        return None
    if cfg.long_context == "native":
        return None
    if cfg.long_context == "window":
        return cfg.long_window
    raise ShapeSkip(f"{cfg.name} skips long_500k ({cfg.long_context})")


def batch_structs(cfg: ModelConfig, global_batch: int, seq_len: int) -> dict:
    """Token (+ frontend) stand-ins for a full-sequence pass."""
    batch = {"tokens": torch.empty((global_batch, seq_len),
                                   dtype=torch.int32, device=_META)}
    if cfg.is_encoder_decoder:
        n_front = cfg.n_enc_tokens
    elif cfg.n_frontend_tokens:
        n_front = cfg.n_frontend_tokens
    else:
        return batch
    batch["frontend"] = torch.empty((global_batch, n_front, cfg.d_model),
                                    dtype=torch.float32, device=_META)
    return batch


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> LoweringSpec:
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    window = resolve_window(cfg, shape)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind in ("train", "prefill"):
        # VLM: frontend patches prepend to the sequence, so the tokens
        # take the rest of the assigned seq_len
        S_tok = S - cfg.n_frontend_tokens if cfg.n_frontend_tokens else S
        return LoweringSpec(cfg, shape, shape.kind, window,
                            (batch_structs(cfg, B, S_tok),))

    # decode: ONE new token against a seq_len-sized cache, one buffer per
    # layer (the unrolled serving layout)
    state = tfm.init_decode_state(cfg, B, S, window=window, stacked=False,
                                  device=_META)
    token = torch.empty((B,), dtype=torch.int32, device=_META)
    return LoweringSpec(cfg, shape, "decode", window, (state, token))
