"""Utility functions (paper §4.1, §11.2): the early-exit confidence test and
per-unit threshold calibration (the Fig. 8 accuracy/latency trade-off),
ported from :mod:`repro.core.utility`.

The margin and entropy utilities are numpy, as in the reference;
:func:`scalarized_objective` is float32 tensor arithmetic on the device of
its inputs; the calibration classifies through the port's
:func:`repro_torch.core.kmeans.classify` (the ``l1_topk2`` kernel on a
card).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .kmeans import UnitClassifier, classify


def margin_utility(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Scale-free cluster margin |Delta2 - Delta1| / (Delta1 + Delta2)."""
    return (d2 - d1) / np.maximum(d1 + d2, 1e-9)


def entropy_utility(probs: np.ndarray) -> np.ndarray:
    """Generic utility for probabilistic classifiers (paper §11.2):
    U = -sum p log2 p; low entropy = confident."""
    p = np.clip(probs, 1e-12, 1.0)
    return -(p * np.log2(p)).sum(-1)


def _as_f32(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(torch.float32)


def scalarized_objective(correct, released, deadline_misses=None,
                         optional_units=None, units_executed=None, *,
                         miss_weight: float = 0.0,
                         optional_weight: float = 0.0) -> torch.Tensor:
    """Scalar fleet-tuning reward: on-time accuracy with optional penalties.

    The base term is ``correct / released`` — the fraction of released jobs
    whose mandatory part finished before the deadline *and* whose final
    prediction was right (the paper's headline "on-time accuracy" metric,
    Figs. 17-20).  ``miss_weight`` subtracts the deadline-miss rate and
    ``optional_weight`` adds the optional-unit fraction.

    Inputs may be python scalars, numpy arrays or tensors (the ``(D,)``
    fleet device axis); counts are cast to f32 and denominators clamped.
    Every product and sum is one f32 rounding, as the reference computes it
    op by op.  Returns a float32 tensor on ``released``'s device.
    """
    device = (released.device if isinstance(released, torch.Tensor)
              else None)
    rel = torch.clamp(_as_f32(released, device), min=1.0)
    score = _as_f32(correct, device) / rel
    if miss_weight and deadline_misses is not None:
        w = torch.tensor(miss_weight, dtype=torch.float32, device=rel.device)
        score = score - w * (_as_f32(deadline_misses, device) / rel)
    if optional_weight and optional_units is not None:
        if units_executed is None:
            raise ValueError(
                "optional_weight needs both optional_units and "
                "units_executed")
        units = torch.clamp(_as_f32(units_executed, device), min=1.0)
        w = torch.tensor(optional_weight, dtype=torch.float32,
                         device=rel.device)
        score = score + w * (_as_f32(optional_units, device) / units)
    return score


def calibrate_threshold(
    uc: UnitClassifier,
    feats: np.ndarray,
    labels: np.ndarray,
    *,
    min_accuracy: float = 0.85,
    grid: int = 50,
):
    """Sweep the utility threshold on held-out features; return the smallest
    threshold whose *exited* samples have accuracy >= min_accuracy (relative
    to this unit's achievable accuracy), plus the full trade-off curve.
    """
    x = torch.as_tensor(np.asarray(feats, np.float32),
                        device=uc.centroids.device)
    pred, d1, d2, _, margin = classify(uc, x)
    pred, margin = pred.cpu().numpy(), margin.cpu().numpy()
    correct = pred == labels
    base_acc = max(correct.mean(), 1e-9)

    thresholds = np.quantile(margin, np.linspace(0.0, 0.98, grid))
    curve = []  # (threshold, exit_fraction, exit_accuracy)
    for t in thresholds:
        exited = margin > t
        frac = exited.mean()
        acc = correct[exited].mean() if exited.any() else 1.0
        curve.append((float(t), float(frac), float(acc)))

    chosen = curve[-1][0]
    for t, frac, acc in curve:
        if acc >= min_accuracy * base_acc:
            chosen = t
            break
    return float(chosen), curve


def calibrate_bank_thresholds(
    bank: Sequence[UnitClassifier],
    per_unit_feats: Sequence[np.ndarray],
    labels: np.ndarray,
    *,
    min_accuracy: float = 0.85,
) -> list[UnitClassifier]:
    out = []
    for uc, feats in zip(bank, per_unit_feats):
        thr, _ = calibrate_threshold(
            uc, feats, labels, min_accuracy=min_accuracy
        )
        out.append(uc._replace(threshold=torch.tensor(
            np.float32(thr), device=uc.centroids.device)))
    return out
