"""Qwen1.5-0.5B — dense MHA with QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig, register

QWEN15_05B = register(
    ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        source="hf:Qwen/Qwen1.5-0.5B",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        act="swiglu",
        rope_theta=1_000_000.0,
        exit_every=3,
        mandatory_units=2,
        long_context="window",
        long_window=4096,
    )
)
