"""Tuning the anytime serving engine's knobs with ``adapt.tune`` (port of
:mod:`repro.adapt.anytime`).

The anytime engine's exit thresholds, energy gate and eta factor are the
engine's dynamic knobs (:class:`repro_torch.serve.anytime.AnytimeKnobs`),
so a candidate block maps onto a batch of knobs, each scored by
:meth:`~repro_torch.serve.anytime.AnytimeServeEngine.score_fn` against the
same request and supply traces.  The reference vmaps one compiled scan
over the block; the port runs the engine once per candidate.

Knob names (the ``SearchSpace`` vocabulary, matching the fleet tuner):

* ``exit_threshold``  — one margin threshold broadcast over all units;
* ``exit_thr_<u>``    — per-unit thresholds (overrides the broadcast);
* ``e_opt_fraction``  — the Eq. 7 energy gate as a fraction of the
  capacitor capacity;
* ``eta``             — the harvest-predictability factor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..serve.anytime import AnytimeKnobs, AnytimeServeEngine, AnytimeTables
from .space import SearchSpace

__all__ = ["anytime_space", "make_anytime_objective", "knobs_from_params"]

_F32 = torch.float32


def anytime_space(engine: AnytimeServeEngine, *, per_unit: bool = False,
                  thr_range=(0.0, 10.0), eta_range=None,
                  e_opt_range=(0.05, 0.95)) -> SearchSpace:
    """The default knob space for one engine.

    ``per_unit=True`` searches an independent threshold per non-final unit
    (``exit_thr_<u>``) instead of one shared ``exit_threshold``;
    ``eta_range=None`` leaves eta out of the search.
    """
    bounds = {}
    if per_unit:
        for u in range(engine.n_units - 1):
            bounds[f"exit_thr_{u}"] = thr_range
    else:
        bounds["exit_threshold"] = thr_range
    bounds["e_opt_fraction"] = e_opt_range
    if eta_range is not None:
        bounds["eta"] = eta_range
    return SearchSpace.of(**bounds)


def knobs_from_params(engine: AnytimeServeEngine, params: dict,
                      base: Optional[AnytimeKnobs] = None) -> AnytimeKnobs:
    """Materialise a scalar parameter dict (e.g. ``TuneResult
    .best_params``) into :class:`AnytimeKnobs`; unnamed knobs keep their
    ``base`` (default) values."""
    batched = _knob_batch(engine, {k: np.asarray([v], np.float32)
                                   for k, v in params.items()}, 1, base)
    return AnytimeKnobs(*[a[0] for a in batched])


def _col(engine, values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32),
                           device=engine.device)


def _knob_batch(engine: AnytimeServeEngine, cand: dict, n: int,
                base: Optional[AnytimeKnobs]) -> AnytimeKnobs:
    """Map ``{name: (N,)}`` candidate columns onto an (N,)-batched
    :class:`AnytimeKnobs`."""
    U = engine.n_units
    k = base if base is not None else engine.default_knobs()
    exit_thr = k.exit_thr.expand(n, U).clone()
    if "exit_threshold" in cand:
        exit_thr = _col(engine, cand["exit_threshold"])[:, None].expand(
            n, U).clone()
    for u in range(U):
        name = f"exit_thr_{u}"
        if name in cand:
            exit_thr[:, u] = _col(engine, cand[name])
    use = k.use_exit_thr.expand(n, U)
    eta = (_col(engine, cand["eta"]) if "eta" in cand
           else k.eta.expand(n))
    e_opt = (_col(engine, cand["e_opt_fraction"]) * engine.scfg.capacity
             if "e_opt_fraction" in cand else k.e_opt.expand(n))
    return AnytimeKnobs(exit_thr=exit_thr, use_exit_thr=use, eta=eta,
                        e_opt=e_opt)


def make_anytime_objective(engine: AnytimeServeEngine, requests, *,
                           tardiness_weight: float = 0.0,
                           base_knobs: Optional[AnytimeKnobs] = None):
    """An ``{name: (N,) array} -> (N,) scores`` objective over the
    engine's deterministic score (on-time agreed-token fraction minus a
    tardiness penalty) for :func:`repro_torch.adapt.tune`."""
    tables = (requests if isinstance(requests, AnytimeTables)
              else engine.pack(requests))
    score = engine.score_fn(tables, tardiness_weight=tardiness_weight)

    def objective(cand: dict) -> np.ndarray:
        n = len(next(iter(cand.values())))
        knobs = _knob_batch(engine, cand, n, base_knobs)
        return np.asarray([float(score(AnytimeKnobs(*[a[i] for a in knobs])))
                           for i in range(n)], np.float32)

    return objective
