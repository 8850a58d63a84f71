"""InternVL2-2B — InternViT frontend (stubbed) + InternLM2-1.8B backbone.
[arXiv:2404.16821]

Per the assignment carve-out, the ViT vision encoder + projector is a stub:
``input_specs()`` provides precomputed patch embeddings of the right shape
(``n_frontend_tokens`` x ``d_model``) which are prepended to the text
sequence.  The config below describes the *language* backbone.
"""
from .base import ModelConfig, register

INTERNVL2_2B = register(
    ModelConfig(
        name="internvl2-2b",
        family="vlm",
        source="arXiv:2404.16821",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92553,
        n_frontend_tokens=256,  # ViT patch embeddings per image (stub)
        act="swiglu",
        rope_theta=1_000_000.0,
        train_microbatches=2,
        exit_every=3,
        long_context="window",
        long_window=4096,
    )
)
