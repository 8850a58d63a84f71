"""The paper's own four DNNs (Table 3) — MNIST / ESC-10 / CIFAR-100 / VWW.

These are CNN feature extractors, not transformers, so they live in their own
registry (:data:`repro.models.cnn.PAPER_CNNS`) rather than the transformer
``ModelConfig`` registry.  This module re-exports them so that
``--arch paper-mnist`` etc. resolve through the configs package.
"""
from ..models.cnn import PAPER_CNNS, CNNConfig  # noqa: F401


def get_cnn_config(name: str) -> CNNConfig:
    key = name.removeprefix("paper-")
    try:
        return PAPER_CNNS[key]
    except KeyError:
        raise KeyError(
            f"unknown paper CNN {name!r}; available: "
            f"{['paper-' + k for k in sorted(PAPER_CNNS)]}"
        ) from None
