"""Loss functions (paper §4.2): contrastive (Eq. 5), layer-aware (Eq. 4),
plus the cross-entropy baseline compared against in Fig. 15 (port of
:mod:`repro.core.losses`).

The layer-aware loss is a convex combination of per-layer contrastive losses
computed on siamese (paired) forward passes — it forces *every* hidden layer
to produce classification-ready (cluster-separable) features, which is what
makes early exit accurate.  Every loss is an f32 scalar and differentiable
by autograd.
"""
from __future__ import annotations

from typing import Sequence

import torch

_F32 = torch.float32


def l1_distance(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Mean (dimension-normalised) L1 distance — matches the classifier's
    metric so the learned geometry and the k-means geometry agree."""
    return torch.mean(torch.abs(f1.to(_F32) - f2.to(_F32)), dim=-1)


def contrastive_loss(f1: torch.Tensor, f2: torch.Tensor,
                     different: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
    """Eq. 5.  different (Y): 0 = same class (pull), 1 = different (push)."""
    d = l1_distance(f1, f2)
    y = different.to(_F32)
    pull = 0.5 * (1.0 - y) * d
    push = 0.5 * y * torch.clamp(margin - d, min=0.0)
    return torch.mean(pull + push)


def layer_aware_loss(feats1: Sequence[torch.Tensor],
                     feats2: Sequence[torch.Tensor],
                     different: torch.Tensor,
                     coeffs: Sequence[float] | None = None,
                     margin: float = 1.0) -> torch.Tensor:
    """Eq. 4: LA = sum_i a_i * LC(layer i), sum a_i = 1.

    Default coefficients weight layers uniformly; they are normalised by
    their sum, as the reference does (``c / sum(c)``)."""
    L = len(feats1)
    if coeffs is None:
        coeffs = [1.0 / L] * L
    c = torch.tensor(coeffs, dtype=_F32, device=different.device)
    c = c / torch.sum(c)
    losses = torch.stack([contrastive_loss(f1, f2, different, margin)
                          for f1, f2 in zip(feats1, feats2)])
    return torch.sum(c * losses)


def final_layer_contrastive(feats1: Sequence[torch.Tensor],
                            feats2: Sequence[torch.Tensor],
                            different: torch.Tensor,
                            margin: float = 1.0) -> torch.Tensor:
    """Baseline [71]: contrastive loss at the last layer only."""
    return contrastive_loss(feats1[-1], feats2[-1], different, margin)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Baseline [142] (and the LM training loss for the big archs):
    ``mean(logsumexp(logits) - logits[label])``."""
    logits = logits.to(_F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token LM loss: predict tokens[:, 1:] from logits[:, :-1]."""
    return cross_entropy(logits[:, :-1], tokens[:, 1:])
