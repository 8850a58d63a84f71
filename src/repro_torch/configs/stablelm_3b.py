"""StableLM-3B — dense, MHA (kv=heads). [hf:stabilityai/stablelm-2-1_6b]"""
from .base import ModelConfig, register

STABLELM_3B = register(
    ModelConfig(
        name="stablelm-3b",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        act="swiglu",
        norm="layernorm",
        rope_theta=10_000.0,
        train_microbatches=4,
        exit_every=4,
        long_context="window",
        long_window=4096,
    )
)
