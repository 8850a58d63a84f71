"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from .base import ModelConfig, register

DBRX_132B = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        source="hf:databricks/dbrx-base",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,  # per-expert FFN width
        vocab=100352,
        n_experts=16,
        top_k=4,
        act="swiglu",
        rope_theta=500_000.0,
        train_microbatches=8,
        exit_every=4,  # 10 Zygarde units of 4 blocks each
        long_context="window",  # full-attention MoE: long_500k via sliding window
        long_window=4096,
    )
)
