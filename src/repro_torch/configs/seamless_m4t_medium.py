"""SeamlessM4T-medium — encoder-decoder, multimodal. [arXiv:2308.11596]

Per the assignment carve-out, the mel-spectrogram + conv feature extractor is
a stub: ``input_specs()`` provides precomputed frame embeddings
(``n_enc_tokens`` x ``d_model``) consumed by the (bidirectional) encoder.  The
schedulable Zygarde units are the *decoder* blocks; the encoder runs once per
job as the first mandatory unit (see DESIGN.md §4).

``long_500k`` is SKIPPED for this architecture (full-attention enc-dec; a
524k-step speech/text decode is outside the family's operating range) — see
DESIGN.md §4.
"""
from .base import ModelConfig, register

SEAMLESS_M4T_MEDIUM = register(
    ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        source="arXiv:2308.11596",
        n_layers=12,  # decoder blocks (the schedulable stack)
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=256206,
        is_encoder_decoder=True,
        n_enc_layers=12,
        n_enc_tokens=1024,  # stubbed audio frame embeddings per utterance
        act="gelu",
        norm="layernorm",
        train_microbatches=2,
        exit_every=2,
        long_context="skip",
    )
)
