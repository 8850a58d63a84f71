"""Training (port of :mod:`repro.train.trainer`): (a) the Zygarde
network-trainer pipeline for agile CNNs (siamese + layer-aware loss ->
k-means bank -> utility thresholds, paper §6), and (b) the LM train step
for the assigned architectures.

Gradients come from autograd.  On a CUDA tensor the model's attention and
RG-LRU layers run kernels G and I forward and their backward kernels
(:mod:`repro_torch.kernels.flash_attn`, :mod:`repro_torch.kernels.
rglru_scan`); on the CPU, the plain paths that follow the reference.
Initial parameters come from a ``torch.Generator``, so a whole run from a
seed does not equal the reference's (``jax.random`` draws other numbers);
the steps themselves (:func:`siamese_step`, :func:`ce_step`,
:func:`train_step_lm`) compute what the reference's do from the same
parameters.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import kmeans as km
from ..core import losses
from ..core import utility as util
from ..data import batches as data_batches
from ..data import make_siamese_pairs, siamese_batches
from ..models import cnn as cnn_mod
from ..models import transformer as tfm
from .optimizer import adamw_init, adamw_update, tree_leaves, tree_map

_F32 = torch.float32


def _value_and_grad(loss_fn, params):
    """``(loss, aux, grads)`` of ``loss_fn(params) -> (loss, aux)``, the
    grads in the params' tree and dtypes (a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = loss_fn(live)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)}
    return loss.detach(), aux, tree_map(lambda p: by_leaf[id(p)], live)


# --------------------------------------------------------------------------- #
# (a) Agile-CNN network trainer (paper §6.1).
# --------------------------------------------------------------------------- #


@dataclass
class TrainedAgileCNN:
    cfg: cnn_mod.CNNConfig
    params: dict
    bank: list
    history: list


def _cnn_feats(cfg, params, x):
    return cnn_mod.cnn_forward_all(cfg, params, x)


def siamese_loss_fn(loss: str = "layer_aware", *, margin: float = 1.0,
                    layer_coeffs: Optional[Sequence[float]] = None):
    """The pair loss of ``loss`` (``layer_aware`` or ``contrastive``)."""
    return {
        "layer_aware": functools.partial(losses.layer_aware_loss,
                                         coeffs=layer_coeffs, margin=margin),
        "contrastive": functools.partial(losses.final_layer_contrastive,
                                         margin=margin),
    }[loss]


def siamese_step(cfg, params: dict, opt, a: torch.Tensor, b: torch.Tensor,
                 d: torch.Tensor, *, loss_fn=None, lr: float = 1e-3):
    """One siamese step: both sides' per-unit features, each normalised by
    the mean of its absolute value over the batch (``f / (mean(|f|) +
    1e-6)``), the pair loss, AdamW.  Returns ``(params, opt, loss)``."""
    loss_fn = loss_fn or siamese_loss_fn()

    def fn(p):
        fa = [f / (f.abs().mean() + 1e-6) for f in _cnn_feats(cfg, p, a)]
        fb = [f / (f.abs().mean() + 1e-6) for f in _cnn_feats(cfg, p, b)]
        return loss_fn(fa, fb, d), None

    l, _, g = _value_and_grad(fn, params)
    params, opt = adamw_update(params, g, opt, lr=lr)
    return params, opt, l


def ce_step(cfg, full: dict, opt, x: torch.Tensor, y: torch.Tensor, *,
            lr: float = 1e-3):
    """One step of the cross-entropy baseline: ``full`` is ``{"net":
    params, "head": {"w", "b"}}``, the head on the last unit's features.
    Returns ``(full, opt, loss)``."""

    def fn(f):
        feats = _cnn_feats(cfg, f["net"], x)
        logits = feats[-1] @ f["head"]["w"] + f["head"]["b"]
        return losses.cross_entropy(logits, y), None

    l, _, g = _value_and_grad(fn, full)
    full, opt = adamw_update(full, g, opt, lr=lr)
    return full, opt, l


def train_agile_cnn(
    dataset,
    *,
    loss: str = "layer_aware",          # layer_aware | contrastive | cross_entropy
    epochs: int = 5,
    batch_size: int = 32,
    n_pairs: int = 2048,
    lr: float = 1e-3,
    margin: float = 1.0,
    layer_coeffs: Optional[Sequence[float]] = None,
    min_exit_accuracy: float = 0.9,
    n_sel: int = 150,
    seed: int = 0,
    cfg: Optional[cnn_mod.CNNConfig] = None,
    device="cuda",
) -> TrainedAgileCNN:
    """Full network-trainer pipeline: train -> fit bank -> calibrate
    thresholds.  ``loss`` selects the paper's layer-aware loss or the two
    baselines of Fig. 15.  ``cfg`` (default: the dataset's Table-3 CNN)
    may narrow the network; initial weights come from a generator seeded
    with ``seed``.  On a CUDA device the calibration classifies through
    kernel D."""
    cfg = cfg or cnn_mod.PAPER_CNNS[dataset.name]
    dev = torch.device(device)
    g = torch.Generator().manual_seed(seed)
    params = cnn_mod.init_cnn_params(cfg, g, device=dev)
    history = []
    on_dev = functools.partial(_to, dev)

    if loss == "cross_entropy":
        # CE baseline needs a classification head on the last feature layer
        feat_dim = cnn_mod._feature_sizes(cfg)[-1]
        head = {"w": (torch.randn((feat_dim, dataset.n_classes), generator=g)
                      * 0.02).to(dev),
                "b": torch.zeros((dataset.n_classes,), device=dev)}
        full = {"net": params, "head": head}
        opt = adamw_init(full)
        for x, y in data_batches(dataset.x_train, dataset.y_train,
                                 batch_size, seed=seed, epochs=epochs):
            full, opt, l = ce_step(cfg, full, opt, on_dev(x), on_dev(y),
                                   lr=lr)
            history.append(float(l))
        params = full["net"]
    else:
        x1, x2, diff = make_siamese_pairs(dataset.x_train, dataset.y_train,
                                          n_pairs, seed=seed)
        loss_fn = siamese_loss_fn(loss, margin=margin,
                                  layer_coeffs=layer_coeffs)
        opt = adamw_init(params)
        for a, b, d in siamese_batches(x1, x2, diff, batch_size, seed=seed,
                                       epochs=epochs):
            params, opt, l = siamese_step(cfg, params, opt, on_dev(a),
                                          on_dev(b), on_dev(d),
                                          loss_fn=loss_fn, lr=lr)
            history.append(float(l))

    # ---- k-means bank + thresholds ----------------------------------------- #
    # Bank fitted on the fit split; utility thresholds calibrated on a
    # HELD-OUT quarter — calibrating on the fit data makes every unit look
    # perfect and drives thresholds to zero (premature exits at deploy).
    n = len(dataset.x_train)
    n_cal = max(32, n // 4)
    fit_x, fit_y = dataset.x_train[: n - n_cal], dataset.y_train[: n - n_cal]
    cal_x, cal_y = dataset.x_train[n - n_cal:], dataset.y_train[n - n_cal:]
    with torch.no_grad():
        feats = [f.cpu().numpy()
                 for f in _cnn_feats(cfg, params, on_dev(fit_x))]
        cal_feats = [f.cpu().numpy()
                     for f in _cnn_feats(cfg, params, on_dev(cal_x))]
    bank = km.fit_bank(feats, fit_y, n_sel=n_sel, seed=seed, device=dev)
    bank = util.calibrate_bank_thresholds(bank, cal_feats, cal_y,
                                          min_accuracy=min_exit_accuracy)
    return TrainedAgileCNN(cfg, params, bank, history)


def _to(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# --------------------------------------------------------------------------- #
# (b) LM training step for the assigned architectures.
# --------------------------------------------------------------------------- #


def lm_grads(cfg, params, batch, *, window: Optional[int] = None,
             microbatches: Optional[int] = None):
    """The gradients of one LM step and its metrics: ``(grads, {"loss",
    "aux", "total"})``.  The loss is next-token CE on the last ``S``
    positions (a VLM's patches are not scored) + ``router_aux_weight`` x
    the MoE aux loss.  ``microbatches > 1`` splits the batch, accumulates
    the grads in f32 in order, divides by the count and casts each to its
    parameter's dtype, as the reference's scan does; peak activation
    memory then scales with the microbatch."""
    mb = microbatches or cfg.train_microbatches

    def loss_fn(p, b):
        logits, aux = tfm.forward(cfg, p, b, window=window)
        S = b["tokens"].shape[1]
        logits = logits[:, -S:]  # VLM: score only the text positions
        lm = losses.lm_loss(logits, b["tokens"])
        return lm + cfg.router_aux_weight * aux, (lm.detach(), aux.detach())

    if mb <= 1:
        total, (l, aux), grads = _value_and_grad(
            lambda p: loss_fn(p, batch), params)
        return grads, {"loss": l, "aux": aux, "total": total}
    B = batch["tokens"].shape[0]
    if B % mb:
        raise ValueError(f"lm_grads: a batch of {B} does not split into "
                         f"{mb} microbatches")
    n = B // mb
    g32 = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                         device=p.device), params)
    l = aux = total = torch.zeros((), dtype=_F32,
                                  device=tree_leaves(params)[0].device)
    for i in range(mb):
        part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        t, (li, ai), g = _value_and_grad(lambda p: loss_fn(p, part), params)
        g32 = tree_map(lambda A, G: A + G.to(_F32), g32, g)
        del g
        l, aux, total = l + li, aux + ai, total + t
    grads = tree_map(lambda G, p: (G / mb).to(p.dtype), g32, params)
    return grads, {"loss": l / mb, "aux": aux / mb, "total": total / mb}


def train_step_lm(cfg, params, opt_state, batch, *, lr: float = 3e-4,
                  window: Optional[int] = None,
                  microbatches: Optional[int] = None):
    """One LM step: :func:`lm_grads`, then AdamW.  Returns ``(params,
    opt_state, {"loss", "aux", "total"})``."""
    grads, metrics = lm_grads(cfg, params, batch, window=window,
                              microbatches=microbatches)
    params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
    return params, opt_state, metrics


def make_train_step(cfg, *, lr: float = 3e-4, window: Optional[int] = None,
                    microbatches: Optional[int] = None):
    """The LM step as a closure ``step(params, opt_state, batch)``."""

    def step(params, opt_state, batch):
        return train_step_lm(cfg, params, opt_state, batch, lr=lr,
                             window=window, microbatches=microbatches)

    return step
