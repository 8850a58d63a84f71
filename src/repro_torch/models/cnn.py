"""The paper's four agile CNNs (Table 3), one per dataset (port of
:mod:`repro.models.cnn`).

Each network is a feature extractor: every layer is one Zygarde *unit*, and
the flattened activation after each unit feeds the per-unit k-means
classifier.  The public layout is the reference's: inputs are NHWC and each
conv unit's features are flattened in NHWC order (the first FC weight and
the classifiers' ``feature_idx`` index that order).  Internally the convs
run as ``F.conv2d`` on NCHW with OIHW weights, so activations are permuted
around each conv.  cuDNN's TF32 is switched off for these convs: it would
round every feature to ~3 decimal digits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_shape: Tuple[int, int, int]  # (H, W, C)
    convs: Tuple[Tuple[int, int, bool], ...]  # (out_ch, kernel, maxpool?)
    fcs: Tuple[int, ...]
    n_classes: int

    @property
    def n_units(self) -> int:
        return len(self.convs) + len(self.fcs)


# Table 3 of the paper (conv dims are out x in x k x k; FC dims out x in).
PAPER_CNNS = {
    "mnist": CNNConfig(
        "mnist", (28, 28, 1), ((20, 5, True), (100, 5, True)), (200, 500), 10
    ),
    "esc10": CNNConfig(
        "esc10", (32, 32, 1),
        ((16, 5, True), (32, 5, True), (64, 5, True)), (95,), 10,
    ),
    "cifar100": CNNConfig(
        "cifar100", (32, 32, 3), ((32, 5, True), (64, 5, True)), (384, 192), 5
    ),
    "vww": CNNConfig(
        "vww", (32, 32, 3),
        ((16, 5, True), (32, 5, True), (64, 5, True), (64, 5, True)), (192,), 2,
    ),
}


def _feature_sizes(cfg: CNNConfig) -> List[int]:
    """Flattened feature size after each unit."""
    h, w, c = cfg.input_shape
    sizes = []
    for out_ch, k, pool in cfg.convs:
        if pool:
            h, w = h // 2, w // 2
        c = out_ch
        sizes.append(h * w * c)
    for out in cfg.fcs:
        sizes.append(out)
    return sizes


def init_cnn_params(cfg: CNNConfig, generator: torch.Generator,
                    device="cuda") -> dict:
    """He-normal weights from ``generator`` (a CPU generator), zero biases.
    Conv weights are OIHW; FC weights are ``(in, out)`` with the input
    index in NHWC-flattened order, as in the reference."""
    params = {"convs": [], "fcs": []}
    c_in = cfg.input_shape[2]
    for out_ch, k, _ in cfg.convs:
        fan = c_in * k * k
        w = torch.randn((out_ch, c_in, k, k), generator=generator)
        params["convs"].append({
            "w": (w * (2.0 / fan) ** 0.5).to(device),
            "b": torch.zeros(out_ch, device=device),
        })
        c_in = out_ch
    in_dim = _feature_sizes(cfg)[len(cfg.convs) - 1]
    for out in cfg.fcs:
        w = torch.randn((in_dim, out), generator=generator)
        params["fcs"].append({
            "w": (w * (2.0 / in_dim) ** 0.5).to(device),
            "b": torch.zeros(out, device=device),
        })
        in_dim = out
    return params


def _conv_unit(p: dict, x: torch.Tensor, pool: bool) -> torch.Tensor:
    """SAME conv (stride 1, odd kernel) + ReLU (+ 2x2 max-pool), NHWC in
    and out."""
    k = p["w"].shape[-1]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], padding=k // 2)
    y = torch.relu(y)
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


def cnn_unit_forward(cfg: CNNConfig, params: dict, x: torch.Tensor,
                     unit: int):
    """Run one unit.  Conv units take/return NHWC; FC units take/return
    ``(B, d)``.  Returns ``(activation, flattened feature (B, feat) f32)``."""
    n_conv = len(cfg.convs)
    if unit < n_conv:
        _, _, pool = cfg.convs[unit]
        y = _conv_unit(params["convs"][unit], x, pool)
        feat = y.reshape(y.shape[0], -1)
        if unit == n_conv - 1:
            y = feat  # next unit is FC
        return y, feat.to(torch.float32)
    p = params["fcs"][unit - n_conv]
    y = torch.relu(x @ p["w"] + p["b"])
    return y, y.to(torch.float32)


def cnn_forward_all(cfg: CNNConfig, params: dict, x: torch.Tensor):
    """Run every unit; returns the list of per-unit flattened features."""
    feats = []
    h = x
    for u in range(cfg.n_units):
        h, f = cnn_unit_forward(cfg, params, h, u)
        feats.append(f)
    return feats
