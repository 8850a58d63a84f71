"""Search-space description for scheduler-parameter tuning (a numpy copy
of :mod:`repro.adapt.space`).

A :class:`SearchSpace` is an ordered tuple of bounded continuous
:class:`Param` knobs.  Candidates travel through the search drivers as
``(N, P)`` float arrays (one row per candidate, one column per knob) and are
handed to objectives as ``{name: (N,) array}`` dicts — the representation
:func:`repro_torch.adapt.objective.apply_params` maps onto
:class:`repro_torch.fleet.state.FleetConfig` fields.

Recognised names (see :mod:`repro_torch.adapt.objective`): ``eta``,
``e_opt_fraction``, ``exit_threshold`` (shared across tasks and units),
``exit_thr_<u>`` (unit column, all tasks), ``exit_thr_t<k>`` (all units of
task ``k``) and ``exit_thr_t<k>_u<u>`` (one task/unit cell) — the last two
address the task-set axis of multi-task devices.  The space itself is
name-agnostic, so synthetic objectives can use any names.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    """One bounded knob: continuous by default, integer-valued with
    ``integer=True`` (candidates snap to whole numbers in :meth:`clip`, so
    the continuous drivers — Gaussian ES offspring included — search the
    lattice transparently; cluster counts and window lengths of the
    forecast controller are the motivating knobs)."""

    name: str
    low: float
    high: float
    integer: bool = False

    def __post_init__(self):
        if not self.high > self.low:
            raise ValueError(f"{self.name}: high must exceed low")
        if self.integer and np.floor(self.high) < np.ceil(self.low):
            raise ValueError(
                f"{self.name}: no integer lies in [{self.low}, {self.high}]")


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    params: Tuple[Param, ...]

    @classmethod
    def of(cls, **bounds: Sequence[float]) -> "SearchSpace":
        """``SearchSpace.of(eta=(0.05, 1.0), e_opt_fraction=(0.05, 0.95),
        n_clusters=(2, 6, int))`` — a third ``int`` (or ``"int"``) element
        marks an integer knob."""
        params = []
        for k, bound in bounds.items():
            lo, hi = bound[0], bound[1]
            integer = len(bound) > 2 and bound[2] in (int, "int")
            params.append(Param(k, float(lo), float(hi), integer=integer))
        return cls(tuple(params))

    @property
    def _integer_mask(self) -> np.ndarray:
        return np.array([p.integer for p in self.params], bool)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    @property
    def n_dims(self) -> int:
        return len(self.params)

    @property
    def lows(self) -> np.ndarray:
        return np.array([p.low for p in self.params], np.float64)

    @property
    def highs(self) -> np.ndarray:
        return np.array([p.high for p in self.params], np.float64)

    @property
    def widths(self) -> np.ndarray:
        return self.highs - self.lows

    def center(self) -> np.ndarray:
        return 0.5 * (self.lows + self.highs)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """(n, P) uniform candidates (integer dims snap to the lattice)."""
        return self.clip(rng.uniform(self.lows, self.highs,
                                     size=(n, self.n_dims)))

    def clip(self, x: np.ndarray) -> np.ndarray:
        x = np.clip(x, self.lows, self.highs)
        mask = self._integer_mask
        if mask.any():
            # snap to the integer lattice *inside* the bounds — rounding a
            # clipped value can escape a fractional bound (5.4 in (2, 5.5)
            # would round to 6), so clamp to [ceil(low), floor(high)]
            snapped = np.clip(np.round(x), np.ceil(self.lows),
                              np.floor(self.highs))
            x = np.where(mask[None, :] if x.ndim == 2 else mask, snapped, x)
        return x

    def grid(self, budget: int) -> np.ndarray:
        """The largest full-factorial lattice that fits in ``budget``
        evaluations: ``r = floor(budget ** (1/P))`` points per dim
        (integer dims enumerate at most their whole-number lattice)."""
        r = max(2, int(np.floor(budget ** (1.0 / self.n_dims))))
        axes = []
        for p in self.params:
            if p.integer:
                ilo, ihi = np.ceil(p.low), np.floor(p.high)
                n_int = int(ihi - ilo) + 1
                axes.append(np.unique(np.round(
                    np.linspace(ilo, ihi, min(r, max(n_int, 2))))))
            else:
                axes.append(np.linspace(p.low, p.high, r))
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=1)

    def to_dict(self, x: np.ndarray) -> Mapping[str, np.ndarray]:
        """(N, P) candidate block -> {name: (N,) column} for objectives."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        return {p.name: x[:, i] for i, p in enumerate(self.params)}
