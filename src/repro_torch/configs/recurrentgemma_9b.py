"""RecurrentGemma-9B — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427 (Griffin)]"""
from .base import ModelConfig, register

RECURRENTGEMMA_9B = register(
    ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        source="arXiv:2402.19427",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,  # MQA on the attention layers
        d_ff=12288,
        vocab=256000,
        block_pattern=("rec", "rec", "attn"),
        rglru_width=4096,
        conv1d_width=4,
        window=2048,  # local attention window (native sub-quadratic)
        act="swiglu",
        train_microbatches=8,
        exit_every=4,
        long_context="native",
    )
)
