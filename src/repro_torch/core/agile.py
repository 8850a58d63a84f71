"""Agile DNN execution (paper §4), ported from :mod:`repro.core.agile`:
unit-wise inference with cluster-based classification, the utility test,
runtime centroid adaptation, and centroid propagation past early exits.

Two frontends share one engine: :class:`AgileCNN` (the paper's CNNs, unit
= one layer) and :class:`AgileTransformer` (the model configs, unit = a
group of ``cfg.exit_every`` blocks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import cnn as cnn_mod
from ..models import transformer as tfm
from . import kmeans as km
from .scheduler import JobProfile


@dataclass
class InferenceResult:
    prediction: int
    exit_unit: int                # unit at which the utility test passed
    units_executed: int
    margin: float
    adapted: bool


class _AgileBase:
    """Shared unit-wise inference over a classifier bank.

    Subclasses provide ``_initial_state(x)``, ``_run_unit(state, u) ->
    (state, feats)``, ``_all_features(xs)`` and ``unit_apply_flat(u,
    flat_feats)`` (centroid propagation)."""

    bank: list

    @property
    def n_units(self) -> int:
        return len(self.bank)

    def profile_batch(self, xs, labels: np.ndarray) -> list[JobProfile]:
        """Full forward for a batch; per-sample JobProfiles."""
        feats = self._all_features(xs)
        B = len(labels)
        margins = np.zeros((B, self.n_units))
        passes = np.zeros((B, self.n_units), bool)
        correct = np.zeros((B, self.n_units), bool)
        for u, f in enumerate(feats):
            uc = self.bank[u]
            pred, _, _, _, margin = km.classify(uc, f)
            margin = margin.cpu().numpy()
            margins[:, u] = margin
            passes[:, u] = margin > uc.threshold.cpu().numpy()
            correct[:, u] = pred.cpu().numpy() == labels
        return [
            JobProfile(margins[i], passes[i], correct[i]) for i in range(B)
        ]

    def infer(
        self, x, *, adapt: bool = True, unit_budget: Optional[int] = None,
        adapt_weight: float = 32.0,
    ) -> InferenceResult:
        """Sequential unit-wise inference with early exit (+ adaptation and
        centroid propagation when the utility test passes)."""
        state = self._initial_state(x)
        budget = unit_budget or self.n_units
        pred, margin, exit_u = -1, 0.0, -1
        for u in range(min(budget, self.n_units)):
            state, feats = self._run_unit(state, u)
            uc = self.bank[u]
            p, _, _, idx, m = km.classify(uc, feats)
            pred, margin = int(p[0]), float(m[0])
            if margin > float(uc.threshold):
                exit_u = u
                if adapt:
                    self.bank[u] = km.adapt(uc, feats, idx,
                                            weight=adapt_weight)
                    self._propagate_from(u, idx)
                break
        return InferenceResult(
            prediction=pred,
            exit_unit=exit_u,
            units_executed=(exit_u + 1) if exit_u >= 0 else min(
                budget, self.n_units),
            margin=margin,
            adapted=adapt and exit_u >= 0,
        )

    def _propagate_from(self, u: int, cluster_idx) -> None:
        """Propagate adapted centroids to the skipped deeper units."""
        for v in range(u, self.n_units - 1):
            self.bank[v + 1] = km.propagate(
                self.bank[v], self.bank[v + 1],
                lambda f, v=v: self.unit_apply_flat(v + 1, f),
                cluster_idx,
            )

    def unit_features(self, xs, *,
                      batch_size: Optional[int] = None) -> list[np.ndarray]:
        """Per-unit features for a request batch, unit 0 over the whole
        batch, then unit 1, ... (features are a pure function of the input,
        so the serving engine computes them once up front).  Returns
        ``n_units`` numpy arrays, entry ``u`` shaped ``(B, F_u)``;
        ``batch_size`` chunks the batch to bound activation memory."""
        if isinstance(xs, (list, tuple)):
            xs = np.stack([np.asarray(x) for x in xs])
        n = len(xs)
        bs = n if batch_size is None else int(batch_size)
        out: list[list[np.ndarray]] = [[] for _ in range(self.n_units)]
        for b0 in range(0, n, bs):
            state = self._initial_state(xs[b0:min(b0 + bs, n)])
            for u in range(self.n_units):
                state, f = self._run_unit(state, u)
                out[u].append(f.cpu().numpy().astype(np.float32))
        return [np.concatenate(c, axis=0) for c in out]


class AgileCNN(_AgileBase):
    """The paper's agile CNNs (unit = one layer); parameters and bank live
    on the device of ``params``."""

    def __init__(self, cfg: cnn_mod.CNNConfig, params: dict,
                 bank: Sequence[km.UnitClassifier]):
        self.cfg, self.params = cfg, params
        self.bank = list(bank)
        self.device = params["convs"][0]["w"].device
        # activation shape entering each unit (for flat->NHWC propagation)
        self._entry_shapes = self._trace_shapes()

    def _trace_shapes(self):
        h = torch.zeros((1, *self.cfg.input_shape), device=self.device)
        shapes = []
        for u in range(self.cfg.n_units):
            shapes.append(tuple(h.shape[1:]))
            h, _ = cnn_mod.cnn_unit_forward(self.cfg, self.params, h, u)
        return shapes

    def _initial_state(self, x):
        x = torch.as_tensor(np.asarray(x, np.float32)
                            if not isinstance(x, torch.Tensor) else x,
                            device=self.device).to(torch.float32)
        if x.dim() == len(self.cfg.input_shape):
            x = x[None]
        return x

    def _run_unit(self, state, u):
        return cnn_mod.cnn_unit_forward(self.cfg, self.params, state, u)

    def _all_features(self, xs):
        return cnn_mod.cnn_forward_all(self.cfg, self.params,
                                       self._initial_state(xs))

    def unit_apply_flat(self, u: int, flat: torch.Tensor) -> torch.Tensor:
        """Apply unit ``u`` to flattened unit-(u-1) features."""
        x = flat.reshape(flat.shape[0], *self._entry_shapes[u]).to(
            torch.float32)
        _, feats = cnn_mod.cnn_unit_forward(self.cfg, self.params, x, u)
        return feats


class AgileTransformer(_AgileBase):
    """Unit = ``cfg.exit_every`` transformer blocks; features = mean-pooled
    hidden states.  For sequence-classification style Zygarde tasks on the
    model configs; parameters and bank live on the device of ``params``."""

    def __init__(self, cfg, params: dict,
                 bank: Sequence[km.UnitClassifier]):
        self.cfg, self.params = cfg, params
        self.bank = list(bank)
        self.device = params["embed"].device

    def _initial_state(self, batch):
        if not isinstance(batch, dict):
            tokens = torch.as_tensor(np.asarray(batch, np.int32)
                                     if not isinstance(batch, torch.Tensor)
                                     else batch, device=self.device)
            batch = {"tokens": tokens}
        return tfm.embed_inputs(self.cfg, self.params, batch)

    def _run_unit(self, state, u):
        x, enc_out = state
        x, pooled = tfm.unit_forward(self.cfg, self.params, x, u,
                                     enc_out=enc_out)
        return (x, enc_out), pooled

    def _all_features(self, batches):
        state = self._initial_state(batches)
        feats = []
        for u in range(self.n_units):
            state, f = self._run_unit(state, u)
            feats.append(f)
        return feats

    def unit_apply_flat(self, u: int, flat: torch.Tensor) -> torch.Tensor:
        """Propagation for pooled features: the centroid as a length-1
        sequence hidden state pushed through unit ``u``."""
        x = flat[:, None, :].to(tfm.dtype_of(self.cfg))
        _, pooled = tfm.unit_forward(self.cfg, self.params, x, u)
        return pooled

    @property
    def n_units_model(self) -> int:
        return self.cfg.n_units
