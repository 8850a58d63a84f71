"""Search drivers: ``adapt.tune(objective, space, budget)`` (a numpy copy
of :mod:`repro.adapt.search`: the same rng calls in the same order).

Every driver treats the objective as a *batched* black box — one call scores
a whole ``(N, P)`` candidate block (one fleet simulation when the objective
comes from :meth:`repro_torch.adapt.objective.TuneProblem.objective`) — and
spends at most ``budget`` candidate evaluations.  All randomness flows from the
``seed`` argument, so runs are reproducible.

Drivers
-------
``random``   uniform sampling in blocks of ``pop_size``.
``grid``     the largest full-factorial lattice that fits the budget.
``es``       (mu + lambda) evolution strategy: Gaussian offspring around the
             elite mean with a geometrically-annealed step size;
             plus-selection keeps the best-so-far monotone.
``es-grad``  antithetic-perturbation ES gradient ascent on the continuous
             knobs: ``g ~ E[(f(x+s e) - f(x-s e)) / 2s * e]`` — the
             smoothed-objective gradient the differentiable-friendly
             scalarization in
             :func:`repro_torch.core.utility.scalarized_objective` is
             designed for.
``cma``      full-covariance CMA-ES (rank-1 + rank-mu updates, cumulative
             step-size adaptation): learns the coupling between knobs —
             e.g. eta and the e_opt fraction trade off through the same
             energy budget — that the isotropic ``es`` ignores.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np

from .space import SearchSpace


@dataclasses.dataclass
class TuneResult:
    driver: str
    best_params: dict
    best_score: float
    n_evals: int
    history: list   # per-block dicts: iteration, n_evals, best_score, ...

    def __repr__(self) -> str:  # compact: history can be long
        p = {k: round(v, 4) for k, v in self.best_params.items()}
        return (f"TuneResult(driver={self.driver!r}, best_score="
                f"{self.best_score:.4f}, best_params={p}, "
                f"n_evals={self.n_evals})")


class _Tracker:
    """Best-so-far bookkeeping shared by every driver."""

    def __init__(self, objective, space: SearchSpace):
        self._obj = objective
        self._space = space
        self.best_x: Optional[np.ndarray] = None
        self.best_score = -np.inf
        self.n_evals = 0
        self.history: list[dict] = []

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(x)
        scores = np.asarray(self._obj(self._space.to_dict(x)),
                            np.float64).reshape(-1)
        if scores.shape[0] != x.shape[0]:
            raise ValueError("objective returned wrong number of scores")
        self.n_evals += x.shape[0]
        i = int(np.argmax(scores))
        if scores[i] > self.best_score:
            self.best_score = float(scores[i])
            self.best_x = x[i].copy()
        self.history.append(dict(
            iteration=len(self.history), n_evals=self.n_evals,
            best_score=self.best_score,
            block_mean=float(scores.mean()), block_max=float(scores.max()),
        ))
        return scores

    def result(self, driver: str) -> TuneResult:
        params = {}
        if self.best_x is not None:
            # integer knobs (Param.integer) come back as python ints so the
            # winning point can be splatted straight into constructors like
            # ForecastController(n_clusters=...)
            params = {p.name: (int(round(v)) if p.integer else float(v))
                      for p, v in zip(self._space.params, self.best_x)}
        return TuneResult(driver=driver, best_params=params,
                          best_score=float(self.best_score),
                          n_evals=self.n_evals, history=self.history)


# --------------------------------------------------------------------------- #
# Drivers.
# --------------------------------------------------------------------------- #


def _random(tr: _Tracker, space, budget, rng, pop, **_):
    while tr.n_evals < budget:
        n = min(pop, budget - tr.n_evals)
        tr.evaluate(space.sample(rng, n))


def _grid(tr: _Tracker, space, budget, rng, pop, **_):
    # space.grid floors at 2 points/dim, which can overshoot tiny budgets —
    # truncate so the at-most-budget contract holds
    lattice = space.grid(budget)[:budget]
    for i in range(0, len(lattice), pop):
        tr.evaluate(lattice[i:i + pop])


def _es(tr: _Tracker, space, budget, rng, pop, *, sigma0=0.25,
        sigma_decay=0.85, elite_frac=0.25, **_):
    lam = min(pop, budget)
    mu = max(1, int(round(lam * elite_frac)))
    x = space.sample(rng, lam)
    s = tr.evaluate(x)
    order = np.argsort(s)[::-1][:mu]
    px, ps = x[order], s[order]
    gen = 0
    while tr.n_evals + lam <= budget:
        gen += 1
        mean = px.mean(axis=0)
        sigma = sigma0 * space.widths * sigma_decay ** gen
        off = space.clip(mean + rng.normal(size=(lam, space.n_dims)) * sigma)
        so = tr.evaluate(off)
        # plus-selection over parents + offspring: elites never regress
        allx = np.concatenate([px, off])
        alls = np.concatenate([ps, so])
        order = np.argsort(alls)[::-1][:mu]
        px, ps = allx[order], alls[order]


def _es_grad(tr: _Tracker, space, budget, rng, pop, *, sigma0=0.15,
             sigma_decay=0.9, lr=0.2, warmup_frac=0.25, **_):
    half = max(1, min(pop, budget) // 2)
    # short random warmup picks the start point (gradient ascent from the
    # space center can sit on a plateau of the energy gate)
    n_warm = max(half, int(budget * warmup_frac)) if budget >= 4 * half else 0
    if n_warm:
        tr.evaluate(space.sample(rng, n_warm))
    theta = (tr.best_x.copy() if tr.best_x is not None else space.center())
    gen = 0
    while tr.n_evals + 2 * half <= budget:
        sigma = sigma0 * space.widths * sigma_decay ** gen
        eps = rng.normal(size=(half, space.n_dims))
        xp = space.clip(theta + sigma * eps)
        xm = space.clip(theta - sigma * eps)
        s = tr.evaluate(np.concatenate([xp, xm]))
        adv = s[:half] - s[half:]
        if np.ptp(s) > 0:   # rank-free normalization for step-size control
            adv = adv / (np.abs(adv).max() + 1e-12)
        grad = (adv[:, None] * eps).mean(axis=0)
        norm = np.linalg.norm(grad)
        if norm > 1e-12:
            step = lr * space.widths * sigma_decay ** gen
            theta = space.clip(theta + step * grad / norm)
        gen += 1
    # ascend from, but never return worse than, the best evaluated point
    if tr.n_evals < budget:
        tr.evaluate(theta[None])


def _cma(tr: _Tracker, space, budget, rng, pop, *, sigma0=0.3, **_):
    """Full-covariance CMA-ES (Hansen's tutorial constants).

    Works in width-normalised coordinates (``x = z * widths``) so one
    relative ``sigma0`` fits heterogeneous knob ranges; the covariance then
    learns the *residual* correlations between knobs.  Selection feeds back
    the *clipped* candidates, so the distribution contracts into the box
    rather than repeatedly sampling outside it.
    """
    n = space.n_dims
    lam = max(4, min(pop, budget))
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w = w / w.sum()
    mu_eff = 1.0 / np.sum(w ** 2)
    cc = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    cs = (mu_eff + 2) / (n + mu_eff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    cmu = min(1 - c1,
              2 * (mu_eff - 2 + 1 / mu_eff) / ((n + 2) ** 2 + mu_eff))
    damps = 1 + 2 * max(0.0, np.sqrt((mu_eff - 1) / (n + 1)) - 1) + cs
    chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n ** 2))

    scale = space.widths
    m = space.center() / scale
    sigma = float(sigma0)
    C = np.eye(n)
    pc = np.zeros(n)
    ps = np.zeros(n)
    gen = 0
    while tr.n_evals + lam <= budget:
        gen += 1
        C = (C + C.T) / 2
        evals, B = np.linalg.eigh(C)
        evals = np.maximum(evals, 1e-20)
        D = np.sqrt(evals)
        z = rng.normal(size=(lam, n))
        y = z @ (B * D).T                      # y ~ N(0, C)
        x = space.clip((m + sigma * y) * scale)
        s = tr.evaluate(x)
        order = np.argsort(s)[::-1][:mu]
        y_sel = (x[order] / scale - m) / sigma  # post-clip steps
        y_w = w @ y_sel
        m = m + sigma * y_w
        c_invsqrt = (B / D) @ B.T
        ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mu_eff) * (
            c_invsqrt @ y_w)
        h_sig = (np.linalg.norm(ps)
                 / np.sqrt(1 - (1 - cs) ** (2 * gen)) / chi_n
                 < 1.4 + 2 / (n + 1))
        pc = (1 - cc) * pc + h_sig * np.sqrt(cc * (2 - cc) * mu_eff) * y_w
        rank_mu = (y_sel * w[:, None]).T @ y_sel
        C = ((1 - c1 - cmu) * C
             + c1 * (np.outer(pc, pc) + (1 - h_sig) * cc * (2 - cc) * C)
             + cmu * rank_mu)
        sigma *= float(np.exp((cs / damps)
                              * (np.linalg.norm(ps) / chi_n - 1)))
        sigma = float(np.clip(sigma, 1e-12, 1e3))


DRIVERS: Mapping[str, Callable] = {
    "random": _random,
    "grid": _grid,
    "es": _es,
    "es-grad": _es_grad,
    "cma": _cma,
}


def tune(objective, space: SearchSpace, budget: int, *,
         driver: str = "es", seed: int = 0, pop_size: Optional[int] = None,
         **driver_kwargs) -> TuneResult:
    """Search ``space`` for the parameters maximising ``objective``.

    objective : ``{name: (N,) array} -> (N,) scores`` (higher is better),
        e.g. :meth:`repro_torch.adapt.objective.TuneProblem.objective`.
    space     : the bounded knobs to search.
    budget    : total candidate evaluations across all blocks.
    driver    : one of ``random | grid | es | es-grad | cma``.
    pop_size  : candidates per objective call (the fleet batch); default
        ``min(16, budget)``.
    """
    if driver not in DRIVERS:
        raise KeyError(f"unknown driver {driver!r}; have {sorted(DRIVERS)}")
    if budget < 1:
        raise ValueError("budget must be >= 1")
    pop = pop_size or min(16, budget)
    tr = _Tracker(objective, space)
    DRIVERS[driver](tr, space, budget, np.random.default_rng(seed), pop,
                    **driver_kwargs)
    return tr.result(driver)
