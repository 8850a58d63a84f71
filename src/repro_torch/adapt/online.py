"""In-trajectory online adaptation: the paper's runtime eta loop (port of
:mod:`repro.adapt.online`).

Zygarde's headline contribution is that the scheduler *re-estimates* eta —
the harvesting-pattern predictability factor of Eq. 3 — from the pattern it
actually observes while deployed, instead of shipping a constant measured
offline.  This module implements that loop on top of segmented fleet
simulation (:func:`repro_torch.fleet.run_segments`) as a composition of pluggable
**controllers**: after every segment the host hook measures shared
statistics (per-segment deadline-miss rate, plus whatever trace windows
each controller asks for) and hands an :class:`Observation` to each
controller in turn; every controller returns updates for the *tunable*
:class:`repro_torch.fleet.state.FleetConfig` tensor fields (``eta``, ``e_opt``,
``exit_thr``/``use_exit_thr``, ``persistent``) that the priority math in
:mod:`repro_torch.core.policy` reads live — the next segment (one launch
of the ``fleet_fused_steps`` kernel in fused mode) reads the new tensors.

Built-in controllers:

* :class:`EtaController` — measures eta over the trailing window of the
  *observed* harvest trace (exactly :func:`repro_torch.core.energy.eta_factor`,
  the offline estimator, applied online to the prefix the device has lived
  through) and smooths the per-segment measurements with an EWMA or
  rolling-quantile estimator — by construction the estimate never leaves
  the envelope of the measurements it has seen, and converges geometrically
  on a stationary trace (``tests/test_online.py`` pins both properties).
* :class:`FeedbackController` — the reactive E_opt strategy: re-tunes the
  threshold from two observed statistics, the *harvest-rate headroom*
  (observed supply vs the task set's mandatory/full-execution demand, a
  feedforward signal that closes the optional-unit gate before a lean
  phase can drain the reserve) and the per-segment *deadline-miss rate*
  (a fast-attack feedback override — any missy segment snaps the threshold
  to its conservative bound).
* :class:`repro_torch.adapt.forecast.ForecastController` — the anticipatory
  strategy: clusters observed harvest windows online, predicts the *next*
  window's supply from per-cluster duration/transition statistics, and
  sets both E_opt and the per-unit ``exit_thr`` tables from the prediction
  (falling back to the feedback law until the forecaster is confident).

Usage::

    adapter = OnlineAdapter(statics, cfg)          # eta + feedback E_opt
    res, carry = fleet.run_segments(cfg, statics, n_segments=128,
                                    hook=adapter.hook)
    adapter.history[-1]["eta_hat"]      # the estimator's trajectory

    # explicit composition (the forecast-aware arm):
    adapter = OnlineAdapter(statics, cfg, controllers=[
        EtaController(rho=0.5, window_s=20.0),
        forecast.ForecastController(window_s=8.0),
    ])

``examples/online_adapt.py`` runs this loop on a nonstationary
(solar -> RF -> occluded) trace where it beats the best static tuned
(eta, E_opt) constants.  The measurements loop over devices in python
(``eta_factor`` is a host-side numpy routine), so the hook is meant for
the adaptation regime — one to a few hundred devices — not for
10^5-device throughput sweeps; those keep the monolithic scan.

Port notes.  The host measurements stay numpy, with the reference's dtypes.
The config and carry leaves the hook reads live on the fleet's device and
are fetched with one ``.cpu()`` per leaf per segment (the read-only
context once per trajectory); the config updates the controllers return
are tensors on the config's device.  When the run threads ``telemetry=``
the hook takes the miss rate from the summary's segment delta instead of
fetching the carry's counters.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np

import torch

from ..core.energy import eta_factor
from ..fleet.state import DeviceState, FleetConfig, FleetStatics

_F32 = np.float32


def host(leaf) -> np.ndarray:
    """A config or carry leaf as a numpy array: one device-to-host copy for
    a tensor, nothing for an array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def on_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array as a contiguous tensor on ``like``'s device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


# --------------------------------------------------------------------------- #
# Estimators: smooth per-segment measurements into a running estimate.
# --------------------------------------------------------------------------- #


class EwmaEstimator:
    """Exponentially-weighted moving average over measurement vectors.

    The first measurement initialises the estimate; each later one moves it
    by ``rho`` of the residual.  Two properties the online loop relies on
    (and the hypothesis tests in ``tests/test_online.py`` verify):

    * **envelope**: for ``rho`` in (0, 1] the estimate is a convex
      combination of past measurements, so it always stays within
      ``[min, max]`` of the measurements seen so far;
    * **convergence**: on a stationary stream (constant measurement ``m``)
      the error contracts geometrically,
      ``|est - m| <= (1 - rho)^n |e0 - m|``.
    """

    def __init__(self, rho: float = 0.5):
        if not 0.0 < rho <= 1.0:
            raise ValueError(f"rho must be in (0, 1], got {rho}")
        self.rho = float(rho)
        self.estimate: Optional[np.ndarray] = None

    def update(self, measurement: np.ndarray) -> np.ndarray:
        m = np.asarray(measurement, np.float64)
        if self.estimate is None:
            self.estimate = m.copy()
        else:
            self.estimate = self.estimate + self.rho * (m - self.estimate)
        return self.estimate


class QuantileEstimator:
    """Rolling-window quantile over the last ``window`` measurements.

    ``q = 0.5`` is a robust (median) alternative to the EWMA when single
    segments can produce outlier eta measurements (very short windows, or a
    burst boundary splitting a segment).  A quantile of observed values
    lies between the window's min and max, so the same envelope property
    holds.
    """

    def __init__(self, q: float = 0.5, window: int = 8):
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.q = float(q)
        self.measurements: deque = deque(maxlen=int(window))
        self.estimate: Optional[np.ndarray] = None

    def update(self, measurement: np.ndarray) -> np.ndarray:
        self.measurements.append(np.asarray(measurement, np.float64))
        self.estimate = np.quantile(
            np.stack(tuple(self.measurements)), self.q, axis=0)
        return self.estimate


ESTIMATORS = {"ewma": EwmaEstimator, "quantile": QuantileEstimator}


# --------------------------------------------------------------------------- #
# Per-segment observed statistics.
# --------------------------------------------------------------------------- #


def observed_eta(events: np.ndarray, t_end: float, slot_s: float,
                 window_s: float, n_max: int = 5) -> np.ndarray:
    """Measure eta per device from the harvest trace observed so far.

    ``events`` is the ``(D, S)`` FleetConfig event stream (0/1 flags or
    fractional amplitudes); only slots strictly before ``t_end`` — the part
    of the trace the device has actually lived through — participate, and
    of those only the trailing ``window_s`` seconds, so the estimate tracks
    a *nonstationary* supply instead of averaging over the whole past.
    Returns ``(D,)`` eta values via :func:`repro_torch.core.energy.eta_factor`
    (Eq. 3) on the binarized window.
    """
    events = np.atleast_2d(np.asarray(events))
    n_seen = int(min(t_end / slot_s, events.shape[1]))
    window = max(int(round(window_s / slot_s)), 2)
    seen = events[:, max(0, n_seen - window):n_seen]
    if seen.shape[1] < 2:
        # nothing observed yet: a patternless prior
        return np.zeros(events.shape[0])
    binary = (seen > 0.0).astype(np.int8)
    return np.array([eta_factor(row, n_max=n_max) for row in binary])


def observed_supply(events: np.ndarray, power_on: np.ndarray, t_end: float,
                    slot_s: float, window_s: float) -> np.ndarray:
    """Mean observed harvest power (W) per device over the trailing
    ``window_s`` seconds before ``t_end`` — the abundance statistic that
    complements :func:`observed_eta`'s predictability statistic."""
    events = np.atleast_2d(np.asarray(events))
    n_seen = int(min(t_end / slot_s, events.shape[1]))
    window = max(int(round(window_s / slot_s)), 1)
    seen = events[:, max(0, n_seen - window):n_seen]
    if seen.shape[1] == 0:
        return np.zeros(events.shape[0])
    return seen.mean(axis=1) * np.asarray(power_on, np.float64)


def workload_demand(cfg: FleetConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per-device (mandatory_rate, full_rate) power demand in watts.

    ``mandatory_rate`` averages each task's mandatory depth over its job
    profiles (first unit whose utility test passes, else the full depth);
    ``full_rate`` assumes every unit of every task runs.  Both are static
    workload facts the deployed scheduler knows, used by the E_opt
    controllers to turn a supply rate into an energy-headroom fraction.
    """
    ue = host(cfg.unit_energy)                 # (D, K, U)
    nu = host(cfg.n_units)                     # (D, K)
    period = host(cfg.period)                  # (D, K)
    passes = host(cfg.passes)                  # (D, K, J, U)
    n_rel = host(cfg.n_releases)               # (D, K)
    d_dev, k_task, _ = ue.shape
    mand = np.zeros(d_dev)
    full = np.zeros(d_dev)
    for d in range(d_dev):
        for k in range(k_task):
            n = int(nu[d, k])
            full[d] += ue[d, k, :n].sum() / period[d, k]
            depths = [
                (int(np.flatnonzero(passes[d, k, j, :n])[0]) + 1
                 if passes[d, k, j, :n].any() else n)
                for j in range(int(n_rel[d, k]))
            ]
            if depths:
                mand[d] += np.mean(
                    [ue[d, k, :dd].sum() for dd in depths]) / period[d, k]
    return mand, full


def miss_rate(carry: DeviceState, prev: Optional[DeviceState]) -> np.ndarray:
    """Per-device deadline-miss fraction of the jobs released during the
    last segment (difference of the carry's cumulative counters).  Each
    carry may hold tensors or host arrays (``m_misses`` and ``next_rel``
    are the only leaves read)."""
    miss = host(carry.m_misses).astype(np.float64).sum(axis=-1)
    rel = host(carry.next_rel).astype(np.float64).sum(axis=-1)
    if prev is not None:
        miss = miss - host(prev.m_misses).astype(np.float64).sum(axis=-1)
        rel = rel - host(prev.next_rel).astype(np.float64).sum(axis=-1)
    return miss / np.maximum(rel, 1.0)


def ewma_supply(prev: Optional[np.ndarray], ctx: "AdapterContext",
                t_end: float, window_s: float, rho: float) -> np.ndarray:
    """One step of the supply tracker shared by the E_opt controllers:
    measure the trailing-window supply and fold it into the running EWMA
    (the first measurement initialises it)."""
    supply = observed_supply(ctx.events, ctx.power_on, t_end,
                             ctx.statics.slot_s, window_s)
    return supply if prev is None else prev + rho * (supply - prev)


def headroom_e_opt_fraction(
    supply: np.ndarray, demand: tuple[np.ndarray, np.ndarray],
    e_opt_bounds: tuple[float, float], miss_rate: np.ndarray,
    miss_target: float,
) -> tuple[np.ndarray, np.ndarray]:
    """The E_opt law shared by the feedback and forecast controllers:
    interpolate the fraction over the energy headroom
    ``(supply - mandatory) / (full - mandatory)`` within ``e_opt_bounds``,
    with the miss fast-attack snapping any missy device to the
    conservative upper bound.  Returns ``(frac, headroom)``; keeping one
    implementation makes the forecast controller's low-confidence
    degradation to the feedback law exact by construction."""
    mand, full = demand
    headroom = (supply - mand) / np.maximum(full - mand, 1e-9)
    lo, hi = e_opt_bounds
    frac = np.clip(hi - (hi - lo) * headroom, lo, hi)
    return np.where(miss_rate > miss_target, hi, frac), headroom


# --------------------------------------------------------------------------- #
# The controller substrate.
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class AdapterContext:
    """Host-side snapshots of the run the controllers read but never
    rewrite, fetched from the device once at the first segment boundary
    (``events`` is the largest leaf)."""

    statics: FleetStatics
    events: np.ndarray          # (D, S)
    power_on: np.ndarray        # (D,)
    capacity: np.ndarray        # (D,) float64
    base_persistent: np.ndarray  # (D,) bool — the config's harvester half


@dataclasses.dataclass(frozen=True)
class Observation:
    """What every controller sees at a segment boundary."""

    seg: int
    t_end: float
    cfg: FleetConfig
    carry: DeviceState
    miss_rate: np.ndarray       # (D,) — jobs missed during the last segment
    ctx: AdapterContext
    #: the last segment's :class:`repro_torch.telemetry.TelemetrySummary`
    #: (a delta) when the run threads ``telemetry=``, else None
    telemetry: Optional[object] = None


class Controller:
    """One adaptation strategy composed into an :class:`OnlineAdapter`.

    ``update`` returns ``(updates, log)``: ``updates`` maps tunable
    FleetConfig field names to new ``(D, ...)`` arrays (merged across
    controllers, later controllers win on conflicts) and ``log`` is merged
    into the adapter's per-segment history entry.
    """

    def reset(self, cfg: Optional[FleetConfig],
              statics: FleetStatics) -> None:
        """Called once at adapter construction (``cfg`` may be None when
        the adapter was built without one; derive lazily in update)."""

    def update(self, obs: Observation) -> tuple[dict, dict]:
        raise NotImplementedError


@dataclasses.dataclass
class EtaController(Controller):
    """Runtime eta re-estimation (the paper's Eq. 3 loop, applied online).

    * ``estimator`` — ``"ewma"`` (weight ``rho``) or ``"quantile"``
      (``q``/``window`` segments), per :data:`ESTIMATORS`; smooths the
      per-segment eta measurements.
    * ``window_s`` / ``n_max`` — trailing trace window and h(N) depth for
      the per-segment :func:`observed_eta`; shorter windows track faster
      but measure noisier.
    """

    estimator: str = "ewma"
    rho: float = 0.5
    q: float = 0.5
    window: int = 8
    window_s: float = 20.0
    n_max: int = 4

    def __post_init__(self):
        if self.estimator not in ESTIMATORS:
            raise ValueError(
                f"unknown estimator {self.estimator!r}; "
                f"choose from {sorted(ESTIMATORS)}")
        self._build_estimator()

    def _build_estimator(self) -> None:
        if self.estimator == "ewma":
            self._est = EwmaEstimator(self.rho)
        else:
            self._est = QuantileEstimator(self.q, self.window)

    def reset(self, cfg: Optional[FleetConfig],
              statics: FleetStatics) -> None:
        # fresh estimator per trajectory, so one controller list can be
        # reused across adapters without leaking the previous eta_hat
        self._build_estimator()

    @property
    def eta_hat(self) -> Optional[np.ndarray]:
        return self._est.estimate

    def update(self, obs: Observation) -> tuple[dict, dict]:
        ctx = obs.ctx
        measured = observed_eta(ctx.events, obs.t_end, ctx.statics.slot_s,
                                self.window_s, self.n_max)
        eta_hat = np.clip(self._est.update(measured), 0.0, 1.0)
        upd = dict(
            eta=on_device(eta_hat.astype(_F32), obs.cfg.eta),
            # the Eq. 6 fast path needs BOTH a persistent harvester and a
            # saturated eta estimate (mirrors adapt.objective.apply_params)
            persistent=on_device(ctx.base_persistent & (eta_hat >= 1.0),
                                 obs.cfg.eta),
        )
        return upd, dict(measured=measured.copy(), eta_hat=eta_hat.copy())


@dataclasses.dataclass
class FeedbackController(Controller):
    """The reactive E_opt strategy: feedforward supply headroom + miss feedback.

    The E_opt fraction interpolates between ``e_opt_bounds`` by the
    observed *energy headroom* ``(supply - mandatory) / (full - mandatory)``
    (supply EWMA-smoothed with ``supply_rho`` over ``supply_window_s``
    trailing seconds), and any segment whose miss fraction exceeds
    ``miss_target`` snaps it to the conservative upper bound.
    """

    supply_window_s: float = 5.0
    supply_rho: float = 0.7
    e_opt_bounds: tuple[float, float] = (0.05, 0.95)
    miss_target: float = 0.1

    def reset(self, cfg: Optional[FleetConfig],
              statics: FleetStatics) -> None:
        self._demand = workload_demand(cfg) if cfg is not None else None
        self._supply_hat: Optional[np.ndarray] = None

    def update(self, obs: Observation) -> tuple[dict, dict]:
        if self._demand is None:
            self._demand = workload_demand(obs.cfg)
        self._supply_hat = ewma_supply(self._supply_hat, obs.ctx, obs.t_end,
                                       self.supply_window_s, self.supply_rho)
        frac, _ = headroom_e_opt_fraction(
            self._supply_hat, self._demand, self.e_opt_bounds,
            obs.miss_rate, self.miss_target)
        upd = dict(e_opt=on_device((frac * obs.ctx.capacity).astype(_F32),
                                   obs.cfg.eta))
        return upd, dict(supply_hat=self._supply_hat.copy(),
                         e_opt_frac=frac.copy())


# --------------------------------------------------------------------------- #
# The adaptation hook.
# --------------------------------------------------------------------------- #


class _MissCounters(NamedTuple):
    """The two cumulative carry counters :func:`miss_rate` reads, on the
    host."""

    m_misses: np.ndarray
    next_rel: np.ndarray


# history keys every entry carries (controllers may add more)
_LOG_DEFAULTS = ("measured", "eta_hat", "supply_hat", "e_opt_frac")


@dataclasses.dataclass
class OnlineAdapter:
    """Controller composition driven as a
    :func:`repro_torch.fleet.run_segments` hook.

    Construct one per trajectory (it carries mutable estimator state),
    passing the run's ``statics`` and the initial ``cfg`` (for the workload
    demand rates), then hand ``adapter.hook`` to ``run_segments``.

    By default the adapter composes the paper's runtime loop —
    ``[EtaController(...), FeedbackController(...)]`` built from the scalar
    fields below (``adapt_e_opt=False`` drops the E_opt strategy); pass
    ``controllers=[...]`` to compose explicitly, e.g. swapping the feedback
    E_opt law for the anticipatory
    :class:`repro_torch.adapt.forecast.ForecastController`.  Updates from later
    controllers override earlier ones on conflicting config fields.
    """

    statics: FleetStatics
    cfg: dataclasses.InitVar[Optional[FleetConfig]] = None
    estimator: str = "ewma"
    rho: float = 0.5
    q: float = 0.5
    window: int = 8
    window_s: float = 20.0
    n_max: int = 4
    adapt_e_opt: bool = True
    supply_window_s: float = 5.0
    supply_rho: float = 0.7
    e_opt_bounds: tuple[float, float] = (0.05, 0.95)
    miss_target: float = 0.1
    controllers: Optional[Sequence[Controller]] = None
    history: list = dataclasses.field(default_factory=list)

    def __post_init__(self, cfg: Optional[FleetConfig]):
        if self.controllers is None:
            self.controllers = [EtaController(
                estimator=self.estimator, rho=self.rho, q=self.q,
                window=self.window, window_s=self.window_s,
                n_max=self.n_max)]
            if self.adapt_e_opt:
                self.controllers.append(FeedbackController(
                    supply_window_s=self.supply_window_s,
                    supply_rho=self.supply_rho,
                    e_opt_bounds=self.e_opt_bounds,
                    miss_target=self.miss_target))
        self.controllers = list(self.controllers)
        for c in self.controllers:
            c.reset(cfg, self.statics)
        self._ctx: Optional[AdapterContext] = None
        # the previous boundary's miss counters, on the host
        self._prev_counts: Optional[_MissCounters] = None
        self._prev_summary = None

    @property
    def eta_hat(self) -> Optional[np.ndarray]:
        """The current ``(D,)`` eta estimate (None before the first hook,
        or when no :class:`EtaController` is composed)."""
        for c in self.controllers:
            if isinstance(c, EtaController):
                return c.eta_hat
        return None

    def hook(self, seg: int, t_end: float, cfg: FleetConfig,
             carry: DeviceState, telemetry=None) -> FleetConfig:
        """``run_segments`` hook: measure, run every controller, rewrite the
        tunable config fields for the next segment.

        When the run threads ``telemetry=`` the hook receives the
        cumulative :class:`repro_torch.telemetry.TelemetrySummary`; the
        miss rate then comes from the summary's segment delta — the same
        as the carry diff (both difference the same step counters) without
        fetching the carry's counters — and the controllers see the
        segment's summary as ``Observation.telemetry``."""
        if self._ctx is None:
            self._ctx = AdapterContext(
                statics=self.statics,
                events=host(cfg.events),
                power_on=host(cfg.power_on),
                capacity=host(cfg.capacity).astype(np.float64),
                # the config's persistent flag conflates harvester and eta;
                # remember the harvester half so a recovering eta can
                # re-widen it
                base_persistent=host(cfg.persistent),
            )
        seg_summary = None
        if telemetry is not None:
            seg_summary = telemetry.delta(self._prev_summary)
            self._prev_summary = telemetry
            rate = seg_summary.miss_rate
        else:
            counts = _MissCounters(host(carry.m_misses),
                                   host(carry.next_rel))
            rate = miss_rate(counts, self._prev_counts)
            self._prev_counts = counts
        obs = Observation(seg=seg, t_end=float(t_end), cfg=cfg, carry=carry,
                          miss_rate=rate, ctx=self._ctx,
                          telemetry=seg_summary)
        upd: dict = {}
        entry: dict = dict(seg=seg, t_end=float(t_end),
                           miss_rate=rate.copy(),
                           **{k: None for k in _LOG_DEFAULTS})
        for c in self.controllers:
            c_upd, c_log = c.update(obs)
            upd.update(c_upd)
            entry.update(c_log)
        self.history.append(entry)
        return cfg._replace(**upd)
