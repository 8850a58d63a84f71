"""Qwen3-MoE-235B-A22B — 128 experts top-8, fine-grained. [hf:Qwen/Qwen3-30B-A3B]"""
from .base import ModelConfig, register

QWEN3_MOE_235B = register(
    ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,  # Qwen3 uses head_dim 128 (not d_model/n_heads)
        d_ff=1536,  # per-expert (fine-grained experts)
        vocab=151936,
        n_experts=128,
        top_k=8,
        act="swiglu",
        rope_theta=1_000_000.0,
        train_microbatches=8,
        exit_every=8,  # 12 Zygarde units (94 layers)
        long_context="window",
        long_window=4096,
    )
)
