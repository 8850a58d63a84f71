"""Harvest-pattern forecasting: cluster observed supply windows, predict
the next one, adapt the scheduler *before* the pattern changes (port of
:mod:`repro.adapt.forecast`).

The paper's premise is that harvested energy is *patterned* — §3 models a
trace by its conditional-event curve h(N) and compresses it into eta — and
:class:`repro_torch.adapt.online.OnlineAdapter` already re-estimates that
pattern statistic mid-trajectory.  But its E_opt law is purely *reactive*:
it follows the observed supply with an EWMA and only snaps conservative
after a missy segment, so every regime change is paid for at least once.
This module adds the anticipatory half:

* :func:`window_features` turns each observed trace window into a small
  feature vector — observed eta (Eq. 3), duty cycle, mean event amplitude,
  ON/OFF run-length statistics (the event inter-arrival structure), and
  the raw Kantorovich-Wasserstein distance of the window's h(N) curve from
  the persistent ideal (:mod:`repro_torch.core.energy`);
* :class:`HarvestForecaster` clusters those windows *online* with the
  semi-supervised k-means machinery of :mod:`repro_torch.core.kmeans` —
  L1 classify + weighted-average centroid adaptation through the
  ``l1_topk2`` and ``centroid_update`` kernels, with the ``pairwise_l1``
  kernel (:func:`repro_torch.kernels.ops.pairwise_l1`) seeding the table
  farthest-point-first, so a whole ``(D, W, F)`` fleet batch classifies in
  one kernel call — and learns, per cluster, the mean
  (eta, supply) of its member windows, the empirical *duration* of stays,
  and the successor-transition counts between clusters (a duration-explicit
  semi-Markov chain over harvest regimes);
* :meth:`HarvestForecaster.predict` combines them: if the device's current
  regime still has expected life left, predict its own statistics; as the
  stay approaches the cluster's learned duration, shift prediction mass to
  the expected successor — with a confidence score that stays 0 until the
  statistics exist;
* :class:`ForecastController` plugs the prediction into the online
  adaptation loop: E_opt interpolates over the *predicted* next-window
  supply headroom (blended with the feedback law by confidence, so an
  unconfident forecaster degrades exactly to feedback), and — once
  confident — the per-unit ``exit_thr`` tables move the mandatory/optional
  boundary with the same headroom: rich forecast -> deeper mandatory
  prefixes, lean forecast -> exit at the first unit and save the reserve
  for the outage the transition model says is coming.

``examples/online_adapt.py`` pits this controller against the
feedback law on the seeded nonstationary solar -> RF -> occluded trace;
the forecast arm must win (pinned by ``tests/test_forecast.py`` and the CI
bench-smoke lane).

Port notes.  The forecaster's tables stay numpy, with the reference's
dtypes; each kernel call moves them to the forecaster's ``device`` (inside
a :class:`ForecastController`, the fleet config's device) and back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from ..core import kmeans
from ..core.energy import h_curve, ideal_h_curve, kw_distance, eta_factor
from ..fleet.state import FleetConfig, FleetStatics
from ..kernels import ops
from .online import (
    Controller,
    host,
    on_device,
    Observation,
    ewma_supply,
    headroom_e_opt_fraction,
    workload_demand,
)

_F32 = np.float32

#: Feature order of :func:`window_features` (F = 6).
FEATURES = ("eta", "duty", "amp", "on_run", "off_run", "h_dist")
F_ETA, F_DUTY, F_AMP, F_ON_RUN, F_OFF_RUN, F_H_DIST = range(len(FEATURES))


# --------------------------------------------------------------------------- #
# Window featurization.
# --------------------------------------------------------------------------- #


def _run_stats(binary: np.ndarray) -> tuple[float, float]:
    """(mean ON-run, mean OFF-run) lengths of a binary row, in slots (0.0
    where a state never occurs) — the event inter-arrival structure."""
    if binary.size == 0:
        return 0.0, 0.0
    edges = np.flatnonzero(np.diff(binary)) + 1
    runs = np.diff(np.concatenate([[0], edges, [binary.size]]))
    values = binary[np.concatenate([[0], edges])]
    on = runs[values > 0]
    off = runs[values == 0]
    return (float(on.mean()) if on.size else 0.0,
            float(off.mean()) if off.size else 0.0)


def window_features(events: np.ndarray, t_end: float, slot_s: float,
                    window_s: float, *, n_max: int = 4, n_windows: int = 1,
                    stride_s: Optional[float] = None) -> np.ndarray:
    """Featurize the trailing windows of every device's observed trace.

    ``events`` is the ``(D, S)`` FleetConfig event stream; like
    :func:`repro_torch.adapt.online.observed_eta`, only slots strictly before
    ``t_end`` participate.  Returns a ``(D, W, F)`` float32 batch — the
    ``n_windows`` trailing windows (oldest first, each ``window_s`` seconds,
    spaced ``stride_s`` apart, the last one ending at ``t_end``) × the
    :data:`FEATURES` columns.  Windows with fewer than two observed slots
    are all-zero (the patternless prior).  Run lengths are normalised by
    the window length so every feature is O(1) and the L1 metric weighs
    them comparably.
    """
    events = np.atleast_2d(np.asarray(events))
    d_dev, n_slots = events.shape
    stride = window_s if stride_s is None else stride_s
    window = max(int(round(window_s / slot_s)), 2)
    ideal = ideal_h_curve(n_max)
    out = np.zeros((d_dev, n_windows, len(FEATURES)), _F32)
    for w in range(n_windows):
        w_end = t_end - (n_windows - 1 - w) * stride
        # clamp at zero: a window ending before the trace starts is empty
        # (a negative slice end would wrap around and leak *future* slots)
        n_seen = max(int(min(w_end / slot_s, n_slots)), 0)
        seen = events[:, max(0, n_seen - window):n_seen]
        if seen.shape[1] < 2:
            continue
        for d in range(d_dev):
            row = seen[d]
            binary = (row > 0.0).astype(np.int8)
            on_run, off_run = _run_stats(binary)
            h = h_curve(binary, n_max)
            obs = np.isfinite(h)
            out[d, w] = (
                eta_factor(binary, n_max=n_max),
                binary.mean(),
                row.mean(),
                on_run / binary.size,
                off_run / binary.size,
                kw_distance(h, np.where(obs, ideal, np.nan)),
            )
    return out


# --------------------------------------------------------------------------- #
# The online forecaster.
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class HarvestForecaster:
    """Online clustering of harvest windows + a duration-explicit
    transition model over the clusters.

    State is host-side numpy; the cluster table is shared across the whole
    fleet (devices pool their pattern statistics), while the regime
    bookkeeping — current cluster, age of the stay — is per device.
    Classify/adapt dispatch to the k-means kernels through
    :func:`repro_torch.core.kmeans.classify_batch` /
    :func:`repro_torch.core.kmeans.online_update`, so one call ingests a
    whole ``(D, W, F)`` window batch; the tables move to ``device`` for
    each call.

    * ``weight`` — centroid inertia of the online update (paper §11.3's
      outlier guard); larger values adapt the table more slowly.
    * ``smoothing`` — Laplace mass spread over *observed* successor
      clusters when normalising transition rows.
    * ``conf_n0`` — confidence half-life: a statistic backed by ``n``
      observations gets weight ``n / (n + conf_n0)``.
    """

    n_clusters: int = 4
    weight: float = 8.0
    smoothing: float = 0.25
    conf_n0: float = 2.0
    spawn_radius: float = 0.75
    device: object = "cuda"

    #: placeholder feature value for unborn centroid rows — far enough (in
    #: L1 over O(1) features) that a live centroid always wins the argmin
    _PLACEHOLDER = 1e6

    def __post_init__(self):
        k = self.n_clusters
        if k < 1:
            raise ValueError(f"n_clusters must be >= 1, got {k}")
        self.centroids: Optional[np.ndarray] = None   # (k, F)
        self.born = np.zeros(k, bool)
        self.counts = np.zeros(k, _F32)
        self.stats_sum = np.zeros((k, 2))             # [eta, supply] sums
        self.stats_n = np.zeros(k)
        self.trans = np.zeros((k, k))                 # successor counts
        self.dur_sum = np.zeros(k)                    # completed stays (obs)
        self.dur_n = np.zeros(k)
        self.cur_cluster: Optional[np.ndarray] = None  # (D,) int
        self.cur_age: Optional[np.ndarray] = None      # (D,) float
        self.n_obs = 0

    @property
    def n_born(self) -> int:
        """How many clusters have been spawned so far (<= ``n_clusters``)."""
        return int(self.born.sum())

    # -- construction ------------------------------------------------------ #

    def _init_centroids(self, flat: np.ndarray) -> None:
        """Seed the table farthest-point-first from the first window batch
        (ties to the all-pairs L1 kernel): centroid 0 is the first window,
        further seeds are added while the most isolated window is more than
        ``spawn_radius`` from every seed.  Remaining rows stay *unborn*
        (placeholder coordinates) until :meth:`observe` spawns them on a
        window outside every live centroid's radius — leader-style online
        k-means, so distinct harvest regimes get distinct clusters instead
        of splitting one seed's jittered copies."""
        k = self.n_clusters
        self.centroids = np.full((k, flat.shape[1]), self._PLACEHOLDER,
                                 _F32)
        chosen = [0]
        if flat.shape[0] > 1:
            x = self._dev(flat)
            dist = host(ops.pairwise_l1(x, x))
            while len(chosen) < min(k, flat.shape[0]):
                mind = dist[:, chosen].min(axis=1)
                mind[chosen] = -1.0
                nxt = int(np.argmax(mind))
                if mind[nxt] <= self.spawn_radius:
                    break
                chosen.append(nxt)
        for j, i in enumerate(chosen):
            self.centroids[j] = flat[i]
            self.born[j] = True

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- online ingestion -------------------------------------------------- #

    def observe(self, feats: np.ndarray, eta: np.ndarray,
                supply: np.ndarray) -> np.ndarray:
        """Ingest one window batch: classify, adapt centroids, update the
        per-cluster (eta, supply) statistics and the duration/transition
        model.

        ``feats``: ``(D, F)`` or ``(D, W, F)`` (windows oldest first);
        ``eta`` / ``supply``: matching ``(D,)`` or ``(D, W)`` per-window
        statistics to learn as predictors.  Returns the assigned cluster
        ids, shaped like ``eta``.
        """
        feats = np.asarray(feats, _F32)
        squeeze = feats.ndim == 2
        if squeeze:
            feats = feats[:, None, :]
        eta = np.asarray(eta, np.float64).reshape(feats.shape[:2])
        supply = np.asarray(supply, np.float64).reshape(feats.shape[:2])
        d_dev, n_win, _ = feats.shape
        flat_feats = feats.reshape(-1, feats.shape[-1])
        if self.centroids is None:
            self._init_centroids(flat_feats)
        feats_t = self._dev(feats)
        idx, d1, _, _ = kmeans.classify_batch(self._dev(self.centroids),
                                              feats_t)
        idx, d1 = host(idx), host(d1)
        # leader-style spawning: a window outside every live centroid's
        # radius births the next unborn cluster at its own coordinates
        # (re-classifying, so other far windows can join the new cluster)
        while (not self.born.all()) and d1.max() > self.spawn_radius:
            far = int(np.argmax(d1.reshape(-1)))
            slot = int(np.argmin(self.born))
            self.centroids[slot] = flat_feats[far]
            self.born[slot] = True
            idx, d1, _, _ = kmeans.classify_batch(
                self._dev(self.centroids), feats_t)
            idx, d1 = host(idx), host(d1)
        # (D, W) assignments
        new_c, new_n = kmeans.online_update(
            self._dev(self.centroids), self._dev(self.counts), feats_t,
            self._dev(idx), self.weight)
        # np.array (a copy): the spawn path writes centroid rows in place
        self.centroids = np.array(host(new_c))
        self.counts = np.array(host(new_n))
        flat = idx.reshape(-1)
        np.add.at(self.stats_sum, flat,
                  np.stack([eta.reshape(-1), supply.reshape(-1)], axis=-1))
        np.add.at(self.stats_n, flat, 1.0)
        for w in range(n_win):
            self._advance(idx[:, w])
        self.n_obs += d_dev * n_win
        return idx[:, -1] if squeeze else idx

    def _advance(self, cur: np.ndarray) -> None:
        """One step of the per-device regime bookkeeping: ages stays, and
        on a cluster change records the completed stay's duration and the
        successor transition."""
        if self.cur_cluster is None:
            self.cur_cluster = cur.astype(np.int64).copy()
            self.cur_age = np.ones(cur.shape[0])
            return
        same = cur == self.cur_cluster
        if not same.all():
            old = self.cur_cluster[~same]
            new = cur[~same]
            np.add.at(self.dur_sum, old, self.cur_age[~same])
            np.add.at(self.dur_n, old, 1.0)
            np.add.at(self.trans, (old, new), 1.0)
        self.cur_age = np.where(same, self.cur_age + 1.0, 1.0)
        self.cur_cluster = cur.astype(np.int64).copy()

    # -- prediction -------------------------------------------------------- #

    def predict(self, horizon: float = 1.0) -> dict:
        """Predict the next window's (eta, supply) per device.

        ``horizon`` is the look-ahead in *observations* (window strides).
        Per device with current cluster ``c``: while the stay's expected
        remaining life covers the horizon, predict ``c``'s own mean
        statistics; as it runs out, blend toward the expected successor's
        (transition-count weighted over clusters with statistics).  Both
        halves are convex combinations of observed per-window (eta, supply)
        values, so predictions never leave the observed envelope
        (``tests/test_forecast.py`` pins this).

        Returns ``{"eta", "supply", "confidence", "w_stay", "cluster"}``,
        each ``(D,)``; confidence is 0 until the statistics exist (and the
        whole dict is zeros before the first :meth:`observe`).
        """
        if self.cur_cluster is None:
            return {key: np.zeros(0) for key in
                    ("eta", "supply", "confidence", "w_stay", "cluster")}
        k = self.n_clusters
        c = self.cur_cluster
        have = self.stats_n > 0
        means = np.where(have[:, None],
                         self.stats_sum / np.maximum(self.stats_n, 1.0)[:, None],
                         0.0)                                   # (k, 2)
        stay = means[c]                                          # (D, 2)
        mean_dur = np.where(self.dur_n > 0,
                            self.dur_sum / np.maximum(self.dur_n, 1.0),
                            np.inf)
        remaining = mean_dur[c] - self.cur_age
        w_stay = np.where(np.isfinite(remaining),
                          np.clip(remaining / max(horizon, 1e-9), 0.0, 1.0),
                          1.0)
        # successor distribution: observed transition counts (self excluded
        # by construction) + Laplace mass over clusters that have statistics
        trans = self.trans * have[None, :]
        has_succ = trans.sum(axis=1) > 0
        smooth = (self.smoothing * have[None, :]
                  * (~np.eye(k, dtype=bool))
                  * has_succ[:, None])
        p = trans + smooth
        p = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
        succ_means = p @ means                                   # (k, 2)
        succ = np.where(has_succ[c][:, None], succ_means[c], stay)
        w2 = w_stay[:, None]
        pred = w2 * stay + (1.0 - w2) * succ
        n0 = self.conf_n0
        # a single member window is no evidence beyond what a reactive
        # supply estimate already sees — confidence starts at the second
        ns = np.maximum(self.stats_n[c] - 1.0, 0.0)
        conf_stay = ns / (ns + n0)
        conf_switch = np.where(has_succ[c],
                               self.dur_n[c] / (self.dur_n[c] + n0), 0.0)
        conf = w_stay * conf_stay + (1.0 - w_stay) * conf_switch
        return dict(eta=pred[:, 0], supply=pred[:, 1], confidence=conf,
                    w_stay=w_stay, cluster=c.copy())


# --------------------------------------------------------------------------- #
# The forecast-aware controller.
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class ForecastController(Controller):
    """Anticipatory E_opt + ``exit_thr`` control from the harvest forecast.

    Per segment it featurizes the trailing ``window_s`` seconds of every
    device's observed trace, feeds the window to the
    :class:`HarvestForecaster`, and asks for the expected supply over the
    next ``horizon_s`` seconds.  The E_opt fraction then interpolates over
    the *predicted* energy headroom exactly as the feedback law does
    over the observed one — the two supplies are blended by the
    forecaster's confidence, so with no learned statistics the controller
    degrades bit-for-bit to
    :class:`repro_torch.adapt.online.FeedbackController`
    (same EWMA, same bounds, same miss fast-attack).

    Once confident (``confidence >= conf_min``) it additionally drives the
    per-unit utility-test thresholds through the tunable
    ``exit_thr``/``use_exit_thr`` substrate: the predicted headroom maps
    into ``depth_bounds`` and the per-task threshold sweeps the workload's
    margin range — 0 sits below every margin (exit at the first unit:
    minimal mandatory demand for the lean window ahead), 1 above every
    margin (the whole DNN becomes mandatory).  A missy segment snaps the
    depth to its floor alongside the E_opt fast-attack.
    """

    window_s: float = 8.0
    n_max: int = 4
    horizon_s: Optional[float] = None      # default: 4 segment lengths
    n_clusters: int = 4
    cluster_weight: float = 8.0
    spawn_radius: float = 0.75
    supply_window_s: float = 5.0
    supply_rho: float = 0.7
    e_opt_bounds: tuple[float, float] = (0.05, 0.95)
    miss_target: float = 0.1
    adapt_exit_thr: bool = True
    depth_bounds: tuple[float, float] = (0.0, 0.5)
    conf_min: float = 0.3
    #: pass an explicit forecaster to carry learned regime statistics into
    #: this trajectory (e.g. from a previous deployment of the same fleet);
    #: left None, a fresh one is built at every reset()
    forecaster: Optional[HarvestForecaster] = None

    def __post_init__(self):
        self._own_forecaster = self.forecaster is None
        if self._own_forecaster:
            self.forecaster = self._fresh_forecaster()

    def _fresh_forecaster(self) -> HarvestForecaster:
        return HarvestForecaster(
            n_clusters=self.n_clusters, weight=self.cluster_weight,
            spawn_radius=self.spawn_radius)

    def reset(self, cfg: Optional[FleetConfig],
              statics: FleetStatics) -> None:
        if self._own_forecaster:
            self.forecaster = self._fresh_forecaster()
        self._demand = workload_demand(cfg) if cfg is not None else None
        self._supply_hat: Optional[np.ndarray] = None
        self._prev_t: Optional[float] = None
        self._thr_lo: Optional[np.ndarray] = None
        if cfg is not None:
            self._init_thresholds(cfg)

    def _init_thresholds(self, cfg: FleetConfig) -> None:
        """Anchor the depth sweep on the workload's margin tables: per
        (device, task), thresholds just below the smallest / above the
        largest live-unit margin reach 'exit at unit 0' / 'full depth
        mandatory' respectively."""
        margins = host(cfg.margins).astype(np.float64)  # (D, K, J, U)
        n_units = host(cfg.n_units)                      # (D, K)
        live = (np.arange(margins.shape[-1])[None, None, :]
                < n_units[:, :, None])                 # (D, K, U)
        m = np.where(live[:, :, None, :], margins, np.nan)
        mlo = np.nanmin(m, axis=(2, 3))
        mhi = np.nanmax(m, axis=(2, 3))
        span = np.maximum(mhi - mlo, 1e-3)
        self._thr_lo = mlo - 0.05 * span
        self._thr_hi = mhi + 0.05 * span
        self._base_use = host(cfg.use_exit_thr)
        self._base_thr = host(cfg.exit_thr)

    def update(self, obs: Observation) -> tuple[dict, dict]:
        ctx = obs.ctx
        if self._demand is None:
            self._demand = workload_demand(obs.cfg)
        if self._thr_lo is None:
            self._init_thresholds(obs.cfg)
        seg_s = obs.t_end - (self._prev_t if self._prev_t is not None
                             else 0.0)
        self._prev_t = obs.t_end
        seg_s = max(seg_s, 1e-9)

        feats = window_features(ctx.events, obs.t_end, ctx.statics.slot_s,
                                self.window_s, n_max=self.n_max)[:, 0, :]
        supply_w = feats[:, F_AMP].astype(np.float64) * ctx.power_on
        first = self.forecaster.n_obs == 0
        # the forecaster's kernels run where the fleet lives
        self.forecaster.device = obs.cfg.eta.device
        self.forecaster.observe(feats, feats[:, F_ETA], supply_w)
        horizon = (self.horizon_s if self.horizon_s is not None
                   else 4.0 * seg_s) / seg_s
        pred = self.forecaster.predict(horizon)
        if first:
            # the opening segment has no history to predict from: degrade
            # exactly to the feedback law (tests pin this fallback)
            pred["confidence"] = np.zeros_like(pred["confidence"])

        # the feedback law's supply tracker as the low-confidence
        # fallback, then the shared E_opt law over the blended supply —
        # with confidence 0 this is the feedback controller by construction
        self._supply_hat = ewma_supply(self._supply_hat, ctx, obs.t_end,
                                       self.supply_window_s, self.supply_rho)
        conf = pred["confidence"]
        supply_eff = conf * pred["supply"] + (1.0 - conf) * self._supply_hat
        frac, headroom = headroom_e_opt_fraction(
            supply_eff, self._demand, self.e_opt_bounds,
            obs.miss_rate, self.miss_target)
        upd = dict(e_opt=on_device((frac * ctx.capacity).astype(_F32),
                                   obs.cfg.eta))
        log = dict(supply_hat=self._supply_hat.copy(), e_opt_frac=frac.copy(),
                   cluster=pred["cluster"].copy(), confidence=conf.copy(),
                   pred_supply=pred["supply"].copy(),
                   pred_eta=pred["eta"].copy())
        if self.adapt_exit_thr:
            dlo, dhi = self.depth_bounds
            depth = dlo + (dhi - dlo) * np.clip(headroom, 0.0, 1.0)
            depth = np.where(obs.miss_rate > self.miss_target, dlo, depth)
            thr = self._thr_lo + depth[:, None] * (self._thr_hi
                                                   - self._thr_lo)  # (D, K)
            enable = conf >= self.conf_min
            table = np.where(enable[:, None, None],
                             np.broadcast_to(thr[:, :, None],
                                             self._base_thr.shape),
                             self._base_thr)
            upd["use_exit_thr"] = on_device(
                np.where(enable, True, self._base_use), obs.cfg.eta)
            upd["exit_thr"] = on_device(table.astype(_F32), obs.cfg.eta)
            log["depth"] = depth.copy()
        return upd, log
