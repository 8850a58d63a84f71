"""GLM4-9B — dense, RoPE, aggressive GQA (kv=2). [hf:THUDM/glm-4-9b]"""
from .base import ModelConfig, register

GLM4_9B = register(
    ModelConfig(
        name="glm4-9b",
        family="dense",
        source="hf:THUDM/glm-4-9b",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab=151552,
        act="swiglu",
        rope_theta=10_000.0,
        train_microbatches=4,
        exit_every=4,
        mandatory_units=3,
        long_context="window",
        long_window=4096,
    )
)
