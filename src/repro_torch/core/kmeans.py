"""Semi-supervised k-means classifier bank (paper §4.3), ported from
:mod:`repro.core.kmeans`.

One classifier per Zygarde unit.  Offline construction (numpy, copied from
the reference): per-unit features -> SelectKBest-style feature selection ->
k-means seeded at class means -> cluster labels by majority vote.  Online
(tensors): L1 classify through the ``l1_topk2`` kernel, the utility test,
weighted-average centroid adaptation through the ``centroid_update``
kernel (its partial and finish entries for a batch cut into blocks), and
centroid *propagation* to deeper layers after early exit (c^{i+1} = (1/r)
sigma(W^{i+1} r c^i)).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..kernels import centroid_update as _cu
from ..kernels import l1_topk2 as _l1
from ..models.common import block_sum


class UnitClassifier(NamedTuple):
    """Classifier state for one unit."""

    centroids: torch.Tensor    # (k, d_full) f32 — full-dim (for propagation)
    labels: torch.Tensor       # (k,) int32 — class label per cluster
    feature_idx: torch.Tensor  # (n_sel,) int32 — SelectKBest dims
    counts: torch.Tensor       # (k,) f32 — cluster sizes (the paper's r)
    threshold: torch.Tensor    # () f32 — utility threshold


# --------------------------------------------------------------------------- #
# Offline construction (network-trainer side; numpy).
# --------------------------------------------------------------------------- #


def select_k_best(
    feats: np.ndarray, labels: np.ndarray, n_sel: int
) -> np.ndarray:
    """ANOVA-F-style scoring (stand-in for the paper's chi^2 SelectKBest,
    which requires non-negative counts): between-class variance over
    within-class variance, top n_sel dims."""
    feats = np.asarray(feats, np.float64)
    classes = np.unique(labels)
    overall = feats.mean(0)
    between = np.zeros(feats.shape[1])
    within = np.zeros(feats.shape[1])
    for c in classes:
        sub = feats[labels == c]
        between += len(sub) * (sub.mean(0) - overall) ** 2
        within += ((sub - sub.mean(0)) ** 2).sum(0)
    score = between / (within + 1e-9)
    n_sel = min(n_sel, feats.shape[1])
    return np.sort(np.argsort(-score)[:n_sel]).astype(np.int32)


def fit_unit_classifier(
    feats: np.ndarray,
    labels: np.ndarray,
    *,
    n_clusters: int | None = None,
    n_sel: int = 150,
    n_iter: int = 10,
    threshold: float = 0.1,
    seed: int = 0,
    device="cuda",
) -> UnitClassifier:
    """Semi-supervised fit: seed centroids at class means, Lloyd-iterate with
    L1 assignment, label clusters by member majority."""
    feats = np.asarray(feats, np.float32)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    k = n_clusters or len(classes)
    per = max(1, k // len(classes))
    rng = np.random.default_rng(seed)

    idx = select_k_best(feats, labels, n_sel)
    fsel = feats[:, idx]

    cents = []
    for c in classes:
        sub = fsel[labels == c]
        cents.append(sub.mean(0))
        for _ in range(per - 1):  # extra seeds: jittered class means
            cents.append(sub[rng.integers(len(sub))])
    cents = np.stack(cents)[:k] if len(cents) >= k else np.stack(
        cents + [fsel[rng.integers(len(fsel))] for _ in range(k - len(cents))]
    )
    k = len(cents)

    for _ in range(n_iter):
        d = np.abs(fsel[:, None, :] - cents[None]).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            members = fsel[assign == j]
            if len(members):
                cents[j] = members.mean(0)

    d = np.abs(fsel[:, None, :] - cents[None]).sum(-1)
    assign = d.argmin(1)
    clabels = np.zeros(k, np.int32)
    counts = np.zeros(k, np.float32)
    for j in range(k):
        member_labels = labels[assign == j]
        counts[j] = max(1.0, len(member_labels))
        clabels[j] = (
            np.bincount(member_labels).argmax() if len(member_labels)
            else classes[j % len(classes)]
        )

    # store FULL-dim centroids (mean of members in full space) for propagation
    cents_full = np.zeros((k, feats.shape[1]), np.float32)
    for j in range(k):
        members = feats[assign == j]
        cents_full[j] = members.mean(0) if len(members) else feats.mean(0)
    cents_full[:, idx] = cents  # selected dims exactly as fitted

    return UnitClassifier(
        centroids=torch.from_numpy(cents_full).to(device),
        labels=torch.from_numpy(clabels).to(device),
        feature_idx=torch.from_numpy(idx).to(device),
        counts=torch.from_numpy(counts).to(device),
        threshold=torch.tensor(np.float32(threshold), device=device),
    )


# --------------------------------------------------------------------------- #
# Online operations (device side).
# --------------------------------------------------------------------------- #


def margin_of(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """The scale-free top-2 margin ``(d2 - d1) / max(d1 + d2, 1e-9)``."""
    floor = torch.full((), 1e-9, dtype=torch.float32, device=d1.device)
    return (d2 - d1) / torch.maximum(d1 + d2, floor)


def classify(uc: UnitClassifier, feats: torch.Tensor):
    """feats: (B, d_full) -> (pred (B,), d1, d2, cluster_idx, margin)."""
    fidx = uc.feature_idx.to(torch.int64)
    fsel = feats[:, fidx].to(torch.float32).contiguous()
    csel = uc.centroids[:, fidx].contiguous()
    d1, d2, idx = _l1.l1_topk2(fsel, csel)
    pred = uc.labels[idx.to(torch.int64)]
    return pred, d1, d2, idx, margin_of(d1, d2)


def utility_test(uc: UnitClassifier, margin: torch.Tensor) -> torch.Tensor:
    """True = confident enough to exit (the margin above the unit's
    threshold)."""
    return margin > uc.threshold


def adapt(
    uc: UnitClassifier, feats: torch.Tensor, cluster_idx: torch.Tensor,
    weight: float = 32.0,
) -> UnitClassifier:
    """Weighted-average centroid update (runs when the utility test passes);
    ``weight`` is the mass of the current centroid (paper §11.3)."""
    cluster_idx = cluster_idx.to(torch.int32).contiguous()
    new_c = _cu.centroid_update(
        uc.centroids.contiguous(), feats.to(torch.float32).contiguous(),
        cluster_idx, weight)
    k = uc.counts.shape[0]
    new_counts = uc.counts + torch.bincount(
        cluster_idx.to(torch.int64), minlength=k)[:k].to(torch.float32)
    return uc._replace(centroids=new_c, counts=new_counts)


def propagate(
    uc_from: UnitClassifier,
    uc_to: UnitClassifier,
    unit_apply: Callable[[torch.Tensor], torch.Tensor],
    cluster_idx: torch.Tensor,
) -> UnitClassifier:
    """Paper §4.3 "updating centroids beyond mandatory layers":
    ``c^{i+1} = (1/r) * sigma(W^{i+1} (r * c^i))``, refreshed only for the
    clusters in ``cluster_idx``."""
    r = uc_from.counts[:, None]
    img = torch.relu(unit_apply(r * uc_from.centroids)) / r
    mask = torch.zeros(uc_from.counts.shape[0], dtype=torch.bool,
                       device=r.device)
    mask[cluster_idx.to(torch.int64)] = True
    return uc_to._replace(
        centroids=torch.where(mask[:, None], img, uc_to.centroids))


# --------------------------------------------------------------------------- #
# Raw-table online operations (fleet-batched): any leading batch shape is
# flattened into the kernels' row axis.  The reference pads lanes to 128 for
# the TPU; the port needs no padding.
# --------------------------------------------------------------------------- #


def classify_batch(centroids: torch.Tensor, x: torch.Tensor):
    """L1-classify a batch ``(..., F)`` against a raw ``(k, F)`` table.
    Returns ``(idx, d1, d2, margin)`` shaped like the batch."""
    batch = x.shape[:-1]
    flat = x.to(torch.float32).reshape(-1, x.shape[-1]).contiguous()
    d1, d2, idx = _l1.l1_topk2(flat, centroids.to(torch.float32).contiguous())
    d1, d2, idx = d1.reshape(batch), d2.reshape(batch), idx.reshape(batch)
    return idx, d1, d2, margin_of(d1, d2)


def online_update(
    centroids: torch.Tensor,
    counts: torch.Tensor,
    x: torch.Tensor,
    idx: torch.Tensor,
    weight: float = 32.0,
):
    """Weighted-average adaptation of a raw ``(k, F)`` table over a batch
    ``x`` ``(..., F)`` (rows with ``idx < 0`` are ignored).  Returns the new
    table and the updated ``(k,)`` member counts."""
    k, f = centroids.shape
    flat = x.to(torch.float32).reshape(-1, f).contiguous()
    aflat = idx.to(torch.int32).reshape(-1).contiguous()
    new_c = _cu.centroid_update(centroids.contiguous(), flat, aflat, weight)
    hits = torch.where(aflat >= 0, aflat, k).to(torch.int64)
    new_counts = counts + torch.bincount(hits, minlength=k + 1)[:k].to(
        torch.float32)
    return new_c, new_counts


def online_update_blocks(
    centroids: torch.Tensor,
    counts: torch.Tensor,
    xs: Sequence[torch.Tensor],
    idxs: Sequence[torch.Tensor],
    weight: float = 32.0,
):
    """:func:`online_update` over a batch cut into blocks (``xs[i]`` ``(B_i,
    F)`` with its ``idxs[i]``, each on its block's device), as the
    reference's program partitions it over a mesh: each block's rows are
    summed per cluster on its own device (kernel E's partial entry, in
    E's row order over the block's rows), the blocks' sums and counts are
    added in block order on the first block's device
    (:func:`repro_torch.models.common.block_sum`), and the summed
    partials are finished there (E's finish entry).  One block is
    :func:`online_update` itself."""
    if len(xs) == 1:
        return online_update(centroids, counts, xs[0], idxs[0], weight)
    k, f = centroids.shape
    parts = [_cu.centroid_partial(
        x.to(torch.float32).reshape(-1, f).contiguous(),
        i.to(torch.int32).reshape(-1).contiguous(), k)
        for x, i in zip(xs, idxs)]
    sums = block_sum([p[0] for p in parts])
    n = block_sum([p[1] for p in parts])
    new_c = _cu.centroid_finish(centroids.contiguous(), sums.contiguous(),
                                n.to(centroids.device), weight)
    return new_c, counts + n.to(counts.device)


# --------------------------------------------------------------------------- #
# Bank helpers.
# --------------------------------------------------------------------------- #


def fit_bank(
    per_unit_feats: Sequence[np.ndarray],
    labels: np.ndarray,
    *,
    n_clusters: int | None = None,
    n_sel: int = 150,
    thresholds: Sequence[float] | None = None,
    seed: int = 0,
    device="cuda",
) -> list[UnitClassifier]:
    bank = []
    for u, feats in enumerate(per_unit_feats):
        thr = thresholds[u] if thresholds is not None else 0.1
        bank.append(
            fit_unit_classifier(
                feats, labels, n_clusters=n_clusters, n_sel=n_sel,
                threshold=thr, seed=seed + u, device=device,
            )
        )
    return bank


def bank_accuracy(
    bank: Sequence[UnitClassifier],
    per_unit_feats: Sequence,
    labels: np.ndarray,
) -> list[float]:
    accs = []
    for uc, feats in zip(bank, per_unit_feats):
        feats = torch.as_tensor(np.asarray(feats, np.float32)
                                if not isinstance(feats, torch.Tensor)
                                else feats, device=uc.centroids.device)
        pred, *_ = classify(uc, feats)
        accs.append(float((pred.cpu().numpy() == labels).mean()))
    return accs
