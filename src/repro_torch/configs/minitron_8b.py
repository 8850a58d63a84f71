"""Minitron-8B — width/depth-pruned Nemotron-4. [arXiv:2407.14679]"""
from .base import ModelConfig, register

MINITRON_8B = register(
    ModelConfig(
        name="minitron-8b",
        family="dense",
        source="arXiv:2407.14679",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab=256000,
        act="relu2",  # Nemotron uses squared-ReLU MLPs
        rope_theta=10_000.0,
        train_microbatches=4,
        exit_every=4,
        long_context="window",
        long_window=4096,
    )
)
