"""xLSTM-125M — alternating mLSTM / sLSTM blocks. [arXiv:2405.04517]

``d_ff=0``: xLSTM blocks carry their own internal up-projection (factor 2)
instead of a separate FFN.  State is O(1) per layer, so ``long_500k`` runs
natively.
"""
from .base import ModelConfig, register

XLSTM_125M = register(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        source="arXiv:2405.04517",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        block_pattern=("mlstm", "slstm"),
        act="gelu",
        norm="layernorm",
        train_microbatches=4,
        exit_every=2,
        mandatory_units=2,
        long_context="native",
    )
)
