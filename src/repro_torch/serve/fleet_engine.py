"""Vectorized live serving: real agile-model execution inside the fleet path
(port of :mod:`repro.serve.fleet_engine`).

Per-unit *features* are a pure function of the input — runtime adaptation
moves only the k-means *centroids* — so the engine precomputes features for
every (job, unit) once, outside the time loop, and keeps only the centroid
bank as evolving state.  Each timestep then, for every device at once:

1. runs the step core's admit / drop-expired / pick stages in ``live`` mode;
2. gathers the selected slot's (task, job, unit) identity;
3. classifies the completing unit's real features against the device's
   current centroid bank through the ``l1_topk2`` kernel (one set of
   centroid rows per device);
4. injects the ``(margin, passed, correct)`` outcome into
   :func:`repro_torch.core.step.apply_step` and writes the outcome log;
5. adapts the bank where the utility test passed for the first time
   (weighted-average update + centroid propagation, paper §4.3).

``run(mode="fused")`` runs each segment as ONE launch of the
``serve_fused_steps`` kernel (steps 1-4 per device in one warp; requires
``adapt=False``).  ``run_stream`` serves a job stream of any length with
O(chunk) device memory: each chunk of the horizon stages only the window
of per-job feature rows its steps can touch and rebases job ids with a
signed ``job0``.  Bank modes: ``per-device`` (every device owns a bank,
leading ``D`` axis) or ``shared`` (one bank; every device's first-pass
exits fold into one ``online_update`` per (task, unit), through the
``centroid_update`` kernel).

Differences from the reference: the reference's ``lax.cond`` that skips
adaptation on steps where no utility test passed is a host-side ``if`` here
— one device synchronisation per step on the card.  Adaptation updates the
run's own copy of the bank in place.  Where the reference compiles its
scan into one program, the card replays each step without telemetry as two
CUDA graphs around kernel D (:class:`_GraphedSteps`).  ``run_stream``
holds one carry at a time (each chunk takes the previous one's output,
which nothing else keeps): the counterpart of the reference's donated carry; the reference's
ahead-of-time compiled chunk programs have none, so ``compile_s`` is 0.
``telemetry=`` (both tiers in ``run``, the counters tier in ``run_stream``)
collects the serve loop's telemetry beside the carry, the serve outcome
unchanged; the fused mode rejects it, as the reference does.  ``mesh=``
runs the scan over the fleet's blocks step by step (:meth:`FleetServeEngine
._scan_blocks`); a shared bank's update sums the blocks' partial sums in
block order, as the reference's partitioned program does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import kmeans as km
from ..core import step as S
from ..core.energy import Capacitor, Harvester
from ..core.scheduler import JobProfile, TaskSpec
from ..fleet import grid
from ..fleet.simulator import finalize_fleet, pack_spec
from ..fleet.state import (
    FleetConfig,
    FleetResult,
    FleetStatics,
    ServeBank,
    ServeCarry,
    ServeLog,
    init_state,
)
from ..kernels import fleet_step, ops
from ..launch import sharding as SH
from ..telemetry import state as T
from ..telemetry import trace as T_trace
from .engine import Request, ServeConfig, per_task

_F32 = torch.float32
_I32 = torch.int32

# padded cluster rows sit this far from everything: never in the L1 top-2
_FAR = 1e15
# the second-minimum mask value (repro_torch.kernels.l1_topk2.POS)
_POS = 1e30


class ServeTables(NamedTuple):
    """Read-only per-request / per-classifier tables of the time loop.

    ``K`` tasks, ``J`` jobs, ``U`` units, ``C`` clusters, ``S`` selected
    features, ``F`` padded full-feature width (one wider than the largest
    real feature dim: the extra column is zero everywhere and is where
    padded ``fidx`` entries point, so padding is L1-exact).  With
    per-device request streams every feature/label leaf gains a leading
    ``D`` axis; the classifier metadata never does.
    """

    sel_feats: torch.Tensor    # ([D,] K, J, U, S) f32 — selected features
    full_feats: torch.Tensor   # ([D,] K, J, U, F) f32 — full (adaptation)
    labels: torch.Tensor       # ([D,] K, J) i32 — request ground truth
    clabels: torch.Tensor      # (K, U, C) i32 — cluster -> class label
    fidx: torch.Tensor         # (K, U, S) i32 — SelectKBest dims (pad F-1)
    thr: torch.Tensor          # (K, U) f32 — bank utility thresholds


@dataclass(frozen=True)
class BankMeta:
    """Static (python) shape metadata for the stacked bank."""

    n_units: tuple           # per task
    n_clusters: tuple        # per (task, unit)
    feat_dim: tuple          # per (task, unit) real feature width
    n_sel: tuple             # per (task, unit) real selected count


def stack_banks(models: Sequence, device="cuda"
                ) -> tuple[ServeBank, dict, BankMeta]:
    """Stack every model's per-unit classifier bank into the padded
    ``(K, U, C, F)`` tables of a :class:`ServeBank` (+ the read-only
    classifier metadata for :class:`ServeTables`).  Dummy cluster rows sit
    at ``_FAR`` with label -1 and count 1; features are zero-padded to a
    common ``F`` with one all-zero trailing column for padded ``fidx``."""
    K = len(models)
    n_units = tuple(m.n_units for m in models)
    U = max(n_units)
    n_clusters = tuple(
        tuple(int(uc.centroids.shape[0]) for uc in m.bank) for m in models)
    feat_dim = tuple(
        tuple(int(uc.centroids.shape[1]) for uc in m.bank) for m in models)
    n_sel = tuple(
        tuple(int(uc.feature_idx.shape[0]) for uc in m.bank) for m in models)
    C = max(max(r) for r in n_clusters)
    S_ = max(max(r) for r in n_sel)
    F = max(max(r) for r in feat_dim) + 1    # +1: the all-zero pad column

    cents = np.full((K, U, C, F), _FAR, np.float32)
    counts = np.ones((K, U, C), np.float32)
    clabels = np.full((K, U, C), -1, np.int32)
    fidx = np.full((K, U, S_), F - 1, np.int32)
    thr = np.zeros((K, U), np.float32)
    for k, m in enumerate(models):
        for u, uc in enumerate(m.bank):
            c = uc.centroids.cpu().numpy().astype(np.float32)
            kc, fu = c.shape
            cents[k, u, :kc, :fu] = c
            cents[k, u, :kc, fu:] = 0.0
            counts[k, u, :kc] = uc.counts.cpu().numpy()
            clabels[k, u, :kc] = uc.labels.cpu().numpy()
            ns = n_sel[k][u]
            fidx[k, u, :ns] = uc.feature_idx.cpu().numpy()
            thr[k, u] = float(uc.threshold)

    def t(a):
        return torch.from_numpy(a).to(device)

    bank = ServeBank(centroids=t(cents), counts=t(counts))
    tables = dict(clabels=t(clabels), fidx=t(fidx), thr=t(thr))
    return bank, tables, BankMeta(n_units, n_clusters, feat_dim, n_sel)


def build_feature_tables(
    models: Sequence,
    requests_per_task: Sequence[Sequence[Request]],
    meta: BankMeta,
    bank_tables: dict,
    *,
    feature_batch: Optional[int] = None,
    n_jobs: Optional[int] = None,
) -> dict:
    """Precompute the (job, unit) feature tables (numpy) for one request
    stream; the selected-dim gather uses the bank's ``fidx``, which never
    adapts.  ``n_jobs`` fixes the job axis (default: longest stream)."""
    K = len(models)
    J = int(n_jobs or max(len(r) for r in requests_per_task))
    fidx = bank_tables["fidx"].cpu().numpy()
    U, S_ = fidx.shape[1], fidx.shape[2]
    F = max(max(r) for r in meta.feat_dim) + 1
    sel = np.zeros((K, J, U, S_), np.float32)
    full = np.zeros((K, J, U, F), np.float32)
    labels = np.full((K, J), -1, np.int32)
    for k, (m, reqs) in enumerate(zip(models, requests_per_task)):
        if not reqs:
            continue
        feats = m.unit_features([r.x for r in reqs],
                                batch_size=feature_batch)
        for u, f in enumerate(feats):
            full[k, :len(reqs), u, :f.shape[1]] = f
            ns = meta.n_sel[k][u]
            sel[k, :len(reqs), u, :ns] = f[:, fidx[k, u, :ns]]
        labels[k, :len(reqs)] = [r.label for r in reqs]
    return dict(sel_feats=sel, full_feats=full, labels=labels)


def classify_unit(bank: ServeBank, tables: ServeTables, tk: int, u: int,
                  job: int):
    """Single-row live classification (plain tensors, shared tables and
    bank) — the same arithmetic and order as :func:`kmeans.classify`.
    Returns ``(margin, cluster_idx, pred)``."""
    fsel = tables.sel_feats[tk, job, u]                       # (S,)
    idxs = tables.fidx[tk, u].to(torch.int64)                 # (S,)
    csel = bank.centroids[tk, u][:, idxs]                     # (C, S)
    d1, d2, ci = ops.l1_topk2(fsel[None].contiguous(), csel.contiguous())
    margin = km.margin_of(d1, d2)[0]
    ci = ci[0]
    return margin, ci, tables.clabels[tk, u, ci.to(torch.int64)]


def _classify_rows(bank: ServeBank, tables: ServeTables, tk, u, job):
    """The rows of the batched classify of every device's selected (task,
    unit, job): ``(features (D, S), centroid columns (D, C, S))``, both
    contiguous, as kernel D takes them.

    ``tk``/``u``/``job`` are ``(D,)``; the bank and the feature tables may
    or may not carry the leading ``D`` axis (shared vs per-device).  Only
    the ``S`` selected columns of the ``C`` centroid rows each device needs
    are gathered; the L1 top-2 then runs through the ``l1_topk2`` kernel
    with one centroid set per row.
    """
    K, Ub, S_ = tables.fidx.shape
    Wl = tables.labels.shape[-1]
    C, F = bank.centroids.shape[-2:]
    D = tk.shape[0]
    ku = tk * Ub + u
    sf = tables.sel_feats.reshape(tables.sel_feats.shape[:-4]
                                  + (K * Wl * Ub, S_))
    fsel = S.take_rows(sf, (tk * Wl + job) * Ub + u)          # (D, S)
    idxs = S.take_rows(tables.fidx.reshape(K * Ub, S_), ku)   # (D, S)
    cflat = bank.centroids.reshape(-1, K * Ub * C * F)        # (D or 1, N)
    iota_c = torch.arange(C, device=tk.device, dtype=torch.int64)
    lin = (((ku.to(torch.int64)[:, None] * C + iota_c[None, :]) * F)[..., None]
           + idxs.to(torch.int64)[:, None, :])                # (D, C, S)
    csel = torch.gather(cflat.expand(D, -1), 1,
                        lin.reshape(D, C * S_)).reshape(D, C, S_)
    return fsel.contiguous(), csel


class _Pick(NamedTuple):
    """What :func:`serve_step` carries from the pick across kernel D's
    launch: the selected slot (pre-apply) and the rows D classifies."""

    sel: torch.Tensor
    picked: torch.Tensor
    run: torch.Tensor
    e_new: torch.Tensor
    tk: torch.Tensor
    u: torch.Tensor
    job: torch.Tensor
    complete: torch.Tensor
    exited_pre: torch.Tensor
    apass_pre: torch.Tensor
    ddl: torch.Tensor
    fsel: torch.Tensor
    csel: torch.Tensor


def _serve_pick(cfg: FleetConfig, tables: ServeTables, dev, bank: ServeBank,
                t, job0, *, statics: FleetStatics, trace: bool = False):
    """:func:`serve_step` up to kernel D: admit → drop-expired → pick, the
    selected slot's identity and the classify's rows.  Returns ``(dev,
    pick)``, and with ``trace`` the stages' trace words after them."""
    K = cfg.period.shape[-1]
    n_u = cfg.unit_time.shape[-1]
    Wl = tables.labels.shape[-1]

    if trace:
        act0 = dev.q_active
        dev, (adm, ev, ev_dl) = S.admit(cfg, dev, t, statics, True,
                                        trace=True)
        dev, (exp, exp_dl) = S.drop_expired(cfg, dev, t, True, trace=True,
                                            q_active_pre=act0)
    else:
        dev = S.admit(cfg, dev, t, statics, True)
        dev = S.drop_expired(cfg, dev, t, True)
    sel, picked, run, e_new = S.pick(cfg, dev, t, statics, True)

    # selected-slot identity, pre-apply
    tk = S._take1(dev.q_task, sel).clamp(0, K - 1)
    u = S._take1(dev.q_unit, sel).clamp(0, n_u - 1)
    job = (S._take1(dev.q_job, sel) - S._take1(job0, tk)).clamp(0, Wl - 1)
    complete = run & (S._take1(dev.q_time_left, sel) - statics.dt
                      <= statics.dt_eps)
    pick = _Pick(sel, picked, run, e_new, tk, u, job, complete,
                 S._take1(dev.q_exited, sel), S._take1(dev.q_apass, sel),
                 S._take1(dev.q_deadline, sel),
                 *_classify_rows(bank, tables, tk, u, job))
    if trace:
        return dev, pick, (act0, adm, ev, ev_dl, exp, exp_dl)
    return dev, pick


def _serve_apply(cfg: FleetConfig, tables: ServeTables, dev, log: ServeLog,
                 t, p: _Pick, d1, d2, ci, *, statics: FleetStatics,
                 words=None):
    """:func:`serve_step` from kernel D's ``(d1, d2, ci)`` on: the margin
    and prediction, :func:`apply_step`, the utility-pass latch and the
    outcome log.  ``words`` (the pick's trace words) traces the step."""
    K = cfg.period.shape[-1]
    Ue = cfg.exit_thr.shape[-1]
    Wl = tables.labels.shape[-1]
    Ub, C = tables.fidx.shape[-2], tables.clabels.shape[-1]
    Q = statics.queue_size
    tk, u, job, complete = p.tk, p.u, p.job, p.complete

    nu_sel = S._take1(cfg.n_units, tk)
    thr_cfg = S._take1(S._flat2(cfg.exit_thr), tk * Ue + u)
    margin = km.margin_of(d1, d2)
    pred = S._take1(tables.clabels.reshape(K * Ub * C), (tk * Ub + u) * C
                    + ci)
    label = S._take1(
        tables.labels.reshape(tables.labels.shape[:-2] + (K * Wl,)),
        tk * Wl + job)
    correct = pred == label
    pass_bank = margin > S._take1(tables.thr.reshape(K * Ub), tk * Ub + u)
    passed = torch.where(cfg.use_exit_thr, margin > thr_cfg, pass_bank)

    if words is not None:
        act0, adm, ev, ev_dl, exp, exp_dl = words
        dev, (comp, comp_dl) = S.apply_step(
            cfg, dev, t, p.sel, p.picked, p.run, p.e_new, statics, True,
            (margin, passed, correct), trace=True, q_active_pre=act0)
    else:
        dev = S.apply_step(cfg, dev, t, p.sel, p.picked, p.run, p.e_new,
                           statics, True, (margin, passed, correct))

    # engine-owned utility-pass latch: adaptation fires at the FIRST
    # bank-threshold pass (even under EDF, which never exits early)
    first_pass = complete & pass_bank & ~p.apass_pre
    oh = S._oh_eq(p.sel, Q)
    dev = dev._replace(
        q_apass=dev.q_apass | (oh & (complete & pass_bank)[..., None]))

    # per-job outcome log (mirrors apply_step's completion math)
    exit_now = complete & cfg.imprecise & (p.exited_pre < 0) & passed
    exited_mid = torch.where(exit_now, u, p.exited_pre)
    full_mand = complete & (exited_mid < 0) & (u + 1 >= nu_sel)
    mand_now = exit_now | full_mand
    sched_now = (t + statics.dt) <= p.ddl
    kk = torch.arange(K, device=tk.device, dtype=_I32)[:, None]
    jj = torch.arange(Wl, device=tk.device, dtype=_I32)[None, :]
    m_jd = (complete[:, None, None] & (kk == tk[:, None, None])
            & (jj == job[:, None, None]))

    def put(old, new, mask=None):
        mm = m_jd if mask is None else m_jd & mask[:, None, None]
        return torch.where(mm, new[:, None, None].to(old.dtype), old)

    log = ServeLog(
        units=put(log.units, u + 1),
        pred=put(log.pred, pred),
        correct=put(log.correct, correct),
        margin=put(log.margin, margin),
        exit_unit=put(log.exit_unit, u, first_pass),
        sched=put(log.sched, sched_now, mand_now),
    )
    if words is not None:
        return dev, log, (first_pass, tk, u, job, ci), S.StepTrace(
            adm=adm, evict=ev, evict_dl=ev_dl, expire=exp, expire_dl=exp_dl,
            complete=comp, complete_dl=comp_dl)
    return dev, log, (first_pass, tk, u, job, ci)


def serve_step(cfg: FleetConfig, tables: ServeTables, dev, bank: ServeBank,
               log: ServeLog, t, job0, *, statics: FleetStatics,
               trace: bool = False):
    """One live-serving timestep for every device (leading ``(D,)`` axis):
    admit → drop-expired → pick → classify against the bank → inject
    ``(margin, passed, correct)`` into :func:`apply_step` → latch the
    utility pass → write the per-job outcome log.

    ``job0`` (``(K,)`` int32) rebases global job ids into the table window
    (zeros for a whole run).  ``t`` is the f32 clock ``i * dt``; the
    step's end time is ``t + dt`` (a second rounding), as in the reference.
    Returns ``(dev, log, (first_pass, tk, u, job, ci))`` — the aux drives
    the engine's bank adaptation.  ``trace`` runs the step core's
    descriptor-emitting stages (the same ops, plus the words) and appends
    the step's :class:`~repro_torch.core.step.StepTrace` to the return.
    The step is :func:`_serve_pick`, kernel D, :func:`_serve_apply`.
    """
    out = _serve_pick(cfg, tables, dev, bank, t, job0, statics=statics,
                      trace=trace)
    dev, pick = out[:2]
    return _serve_apply(cfg, tables, dev, log, t, pick,
                        *ops.l1_topk2(pick.fsel, pick.csel), statics=statics,
                        words=out[2] if trace else None)


def _shift_log(log: ServeLog, shift: torch.Tensor) -> ServeLog:
    """Advance the per-task log window by ``shift`` (``(K,)`` int) jobs.

    Row ``j`` of the new window is row ``j + shift[k]`` of the old; rows
    shifted in from beyond the old window reset to the t=0 defaults (the
    values of :meth:`FleetServeEngine.build`'s ``log0``, so a job that is
    never served reads the same in streamed and monolithic runs)."""
    Wl = log.units.shape[-1]
    jj = torch.arange(Wl, device=shift.device, dtype=torch.int64)
    src = jj[None, :] + shift.to(torch.int64)[:, None]          # (K, Wl)
    valid = src < Wl
    srcc = src.clamp(0, Wl - 1)

    def gather(leaf, default):
        moved = torch.gather(leaf, -1, srcc.expand(leaf.shape))
        return torch.where(valid, moved,
                           torch.full((), default, dtype=leaf.dtype,
                                      device=leaf.device))

    return ServeLog(
        units=gather(log.units, 0),
        pred=gather(log.pred, -1),
        correct=gather(log.correct, False),
        margin=gather(log.margin, 0.0),
        exit_unit=gather(log.exit_unit, -1),
        sched=gather(log.sched, False),
    )


class StreamChunk(NamedTuple):
    """One chunk of :meth:`FleetServeEngine.run_stream`, its window of the
    feature/label tables already on the engine's device."""

    s0: int                 # first step of the chunk
    s1: int                 # one past its last step
    w0: np.ndarray          # (K,) int64: first window row per task
    tables: ServeTables     # the window's tables, job axis Wl wide
    job0: torch.Tensor      # (K,) int32 ``w0``, negative on the first chunks
    shift: torch.Tensor     # (K,) int32: rows the log window advances by
    copy_s: float           # host seconds of the window's copy to the device


@dataclass
class FleetServeResult:
    """Outcome of one vectorized live-serving run.

    ``fleet`` holds the step core's ``(D,)`` aggregates (live-mode
    finalize); the per-job arrays are the numpy view of the
    :class:`ServeLog` (``(D, K, J)`` each); ``carry`` is the end-of-horizon
    :class:`ServeCarry`.  ``wall_s`` times the time loop and finalize only
    (feature precompute excluded), ending in a device synchronisation;
    a stream's ``wall_s`` also counts each chunk's copy of its window to
    the device.
    """

    fleet: FleetResult
    units: np.ndarray
    pred: np.ndarray
    correct: np.ndarray
    margin: np.ndarray
    exit_unit: np.ndarray
    sched: np.ndarray
    carry: ServeCarry
    jobs: int
    wall_s: float
    #: the run's ``(D, ...)`` telemetry when ``telemetry=`` was given
    telemetry: Optional[T.Telemetry] = None
    #: always 0 in the port (nothing is compiled ahead of a run); kept for
    #: the reference's result shape
    compile_s: float = 0.0
    #: ``torch.cuda.max_memory_allocated`` over a stream: every live
    #: allocation on the engine's card, not only the stream's (0 on the CPU)
    peak_bytes: int = 0
    #: device bytes of ONE staged window of tables: the O(chunk) resident
    #: footprint that replaces the O(total jobs) tables of ``run``
    chunk_table_bytes: int = 0
    n_chunks: int = 1

    @property
    def jobs_per_sec(self) -> float:
        return self.jobs / max(self.wall_s, 1e-9)


class _GraphedSteps:
    """:func:`serve_step` on the card as two CUDA graph replays around
    kernel D's launch, for steps without telemetry.

    The eager step is ~700 launches of small ops at 64 devices, so its
    host's launch rate bounds it (a few % device busy).  Here the pick and
    the apply halves are each captured once per call and replayed every
    step; kernel D is launched between them by its wrapper, as in
    :func:`serve_step`, so its count rises once a step.  The graphs read
    the carry from copies of ``dev`` and ``log`` that the apply graph
    overwrites with the step's carry, and the bank where it lies, so the
    adaptation's in-place updates between steps reach the next step.  The
    same kernels on the same inputs: the outcome is the eager step's, bit
    for bit."""

    def __init__(self, cfg: FleetConfig, tables: ServeTables,
                 carry: ServeCarry, job0, *, statics: FleetStatics):
        dev, bank, log = carry
        self.dev = type(dev)(*[x.clone() for x in dev])
        self.log = ServeLog(*[x.clone() for x in log])
        self.t = torch.zeros((), dtype=_F32, device=dev.energy.device)
        self.d = (torch.zeros_like(dev.energy, dtype=_F32),
                  torch.zeros_like(dev.energy, dtype=_F32),
                  torch.zeros_like(dev.energy, dtype=_I32))
        self.dt = statics.dt

        def pick():
            return _serve_pick(cfg, tables, self.dev, bank, self.t, job0,
                               statics=statics)

        def apply(dev1, p):
            return _serve_apply(cfg, tables, dev1, self.log, self.t, p,
                                *self.d, statics=statics)

        # one pass outside capture first (torch.cuda.graphs' warm-up); it
        # writes nothing that the graphs read
        side = torch.cuda.Stream(self.t.device)
        side.wait_stream(torch.cuda.current_stream(self.t.device))
        with torch.cuda.stream(side):
            apply(*pick())
        torch.cuda.current_stream(self.t.device).wait_stream(side)
        self.g_pick, self.g_apply = torch.cuda.CUDAGraph(), \
            torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.g_pick):
            self._dev1, self.pick = pick()
        with torch.cuda.graph(self.g_apply):
            dev2, log2, self.aux = apply(self._dev1, self.pick)
            for old, new in zip(self.dev + self.log, dev2 + log2):
                if new is not old:
                    old.copy_(new)

    def __call__(self, i: int):
        """Step ``i``; returns its aux ``(first_pass, tk, u, job, ci)``,
        valid until the next call."""
        # S.step_clock's value: f32(i) * f32(dt), rounded once
        self.t.fill_(float(np.float32(i) * np.float32(self.dt)))
        self.g_pick.replay()
        for out, x in zip(self.d, ops.l1_topk2(self.pick.fsel,
                                               self.pick.csel)):
            out.copy_(x)
        self.g_apply.replay()
        return self.aux


class FleetServeEngine:
    """Vectorized live serving of agile-model tasks across a device fleet.

    ``bank_mode`` is ``"per-device"`` or ``"shared"``; ``feature_batch``
    chunks the feature precompute; ``device`` is where every tensor of the
    run lives (the models' parameters must live there too).
    """

    def __init__(
        self,
        models: Sequence,
        harvester: Harvester,
        eta: float,
        cap: Optional[Capacitor] = None,
        config: Optional[ServeConfig] = None,
        *,
        bank_mode: str = "per-device",
        feature_batch: Optional[int] = None,
        adapt_weight: float = 32.0,
        device="cuda",
    ):
        if bank_mode not in ("per-device", "shared"):
            raise ValueError(f"unknown bank_mode {bank_mode!r}")
        self.models = list(models)
        self.harvester = harvester
        self.eta = eta
        self.cap = cap or Capacitor()
        self.config = config or ServeConfig()
        self.bank_mode = bank_mode
        self.feature_batch = feature_batch
        self.adapt_weight = float(adapt_weight)
        self.device = torch.device(device)
        self.bank0, self._bank_tables, self.meta = stack_banks(
            self.models, device=self.device)

    # ------------------------------------------------------------------ #
    # Builders.
    # ------------------------------------------------------------------ #

    def _task_specs(self, n_jobs_per_task: Sequence[int]) -> list[TaskSpec]:
        """TaskSpecs with *dummy* zero profiles: live mode never reads the
        replay tables, but the grid builder sizes ``n_releases`` and the
        clip bounds from them."""
        cfg = self.config
        periods = per_task(cfg.period, len(self.models))
        deadlines = per_task(cfg.deadline, len(self.models))
        tasks = []
        for tid, (m, n_jobs) in enumerate(zip(self.models,
                                              n_jobs_per_task)):
            nu = m.n_units
            ut = (np.asarray(cfg.unit_time, float)
                  if cfg.unit_time is not None else np.full(nu, 0.2))
            ue = (np.asarray(cfg.unit_energy, float)
                  if cfg.unit_energy is not None else np.full(nu, 5e-3))
            zeros = JobProfile(np.zeros(nu), np.zeros(nu, bool),
                               np.zeros(nu, bool))
            tasks.append(TaskSpec(
                task_id=tid, period=periods[tid], deadline=deadlines[tid],
                unit_time=ut[:nu], unit_energy=ue[:nu],
                profiles=[zeros] * n_jobs,
                fragments_per_unit=cfg.fragments_per_unit,
            ))
        return tasks

    def _streams(self, requests, n_devices):
        """``(D, streams, per_dev)``: ``requests`` is one stream shared by
        every device (``requests[task][job]``) or per-device streams
        (``requests[device][task][job]``); ``streams`` has one entry per
        device either way."""
        per_dev = not isinstance(requests[0][0], Request)
        if per_dev:
            D = len(requests)
            if n_devices is not None and n_devices != D:
                raise ValueError(
                    f"n_devices={n_devices} but {D} request streams given")
            streams = requests
        else:
            D = int(n_devices or 1)
            streams = [requests] * D
        if len(streams[0]) != len(self.models):
            raise ValueError(
                f"{len(streams[0])} request streams per device for "
                f"{len(self.models)} models")
        return D, streams, per_dev

    def _fleet_config(self, tasks, D: int, seeds):
        """The stacked per-device configs (one harvest trace per seed,
        default ``config.seed`` on every device) and the statics."""
        cfg = self.config
        dt = grid._check_dt(
            grid._default_dt(tasks) if cfg.sim_dt is None
            else float(cfg.sim_dt), tasks)
        statics = FleetStatics(queue_size=cfg.queue_size, dt=dt,
                               horizon=cfg.horizon,
                               slot_s=self.harvester.slot_s)
        seeds = (list(seeds) if seeds is not None else [cfg.seed] * D)
        if len(seeds) != D:
            raise ValueError(f"{len(seeds)} seeds for {D} devices")
        events = {s: grid.sample_events(self.harvester, cfg.horizon, s)
                  for s in set(seeds)}
        devs = [grid.device_config(
            tasks, self.harvester, self.eta, self.cap,
            policy=cfg.policy, horizon=cfg.horizon, events=events[s],
            e_opt_fraction=cfg.e_opt_fraction,
            start_charged=cfg.start_charged,
        ) for s in seeds]
        return grid.stack_configs(devs, device=self.device), statics

    def _feature_tables(self, streams, per_dev: bool, n_jobs: int) -> dict:
        """The numpy feature/label tables over ``n_jobs`` jobs: one set
        shared by every device, or a leading ``D`` axis for per-device
        streams."""
        feats = [build_feature_tables(
            self.models, s, self.meta, self._bank_tables,
            feature_batch=self.feature_batch, n_jobs=n_jobs)
            for s in (streams if per_dev else streams[:1])]
        if per_dev:
            return {k: np.stack([f[k] for f in feats]) for k in feats[0]}
        return feats[0]

    def build(
        self,
        requests,
        n_devices: Optional[int] = None,
        *,
        seeds: Optional[Sequence[int]] = None,
    ) -> tuple[FleetConfig, FleetStatics, ServeTables, ServeCarry, bool]:
        """Materialise configs, statics, feature tables and the t=0 carry.

        ``requests`` is one stream shared by every device
        (``requests[task][job]``) or per-device streams
        (``requests[device][task][job]``).  Returns ``(cfg, statics,
        tables, carry0, per_dev_tables)``.
        """
        D, streams, per_dev = self._streams(requests, n_devices)
        n_jobs = [max(len(s[k]) for s in streams)
                  for k in range(len(self.models))]
        fleet_cfg, statics = self._fleet_config(self._task_specs(n_jobs), D,
                                                seeds)
        stacked = self._feature_tables(streams, per_dev, max(n_jobs))
        tables = ServeTables(
            **{k: torch.from_numpy(v).to(self.device)
               for k, v in stacked.items()},
            **self._bank_tables)

        dev0 = init_state(fleet_cfg, statics)
        log0 = self.log0(D, max(n_jobs))
        return (fleet_cfg, statics, tables,
                ServeCarry(dev=dev0, bank=self._bank0(D), log=log0), per_dev)

    def _bank0(self, D: int) -> ServeBank:
        """The t=0 bank: one copy per device in ``per-device`` mode."""
        if self.bank_mode == "shared":
            return self.bank0
        return ServeBank(*[l.expand((D,) + tuple(l.shape)).contiguous()
                           for l in self.bank0])

    def log0(self, D: int, J: int) -> ServeLog:
        """The t=0 outcome log of ``D`` devices over a ``J``-job window."""
        K = len(self.models)

        def full(value, dtype):
            return torch.full((D, K, J), value, dtype=dtype,
                              device=self.device)

        return ServeLog(units=full(0, _I32), pred=full(-1, _I32),
                        correct=full(False, torch.bool),
                        margin=full(0.0, _F32), exit_unit=full(-1, _I32),
                        sched=full(False, torch.bool))

    # ------------------------------------------------------------------ #
    # Bank adaptation (updates the run's own bank copy in place).
    # ------------------------------------------------------------------ #

    def _adapt_per_device(self, bank: ServeBank, x_full, tk, u, ci, do):
        """Every adapting device's weighted-average update of its own row
        ``(w c + x) / (w + 1)`` and the propagation chain that refreshes row
        ``ci`` of each deeper unit from the progressively updated shallower
        tables, as the reference's per-device loop does."""
        w = self.adapt_weight
        cents, counts = bank
        D = cents.shape[0]
        ar = torch.arange(D, device=cents.device)
        tk_, u_, ci_ = (v.to(torch.int64) for v in (tk, u, ci))
        rows = cents[ar, tk_, u_, ci_]                        # (D, F)
        denom = torch.full((), w + 1.0, dtype=_F32, device=cents.device)
        new_rows = (w * rows + x_full) / denom
        cents[ar, tk_, u_, ci_] = torch.where(do[:, None], new_rows, rows)
        counts[ar, tk_, u_, ci_] += do.to(_F32)
        for k, m in enumerate(self.models):
            for v in range(m.n_units - 1):
                act = (do & (tk == k) & (u <= v)).nonzero()[:, 0]
                if act.numel() == 0:
                    continue
                kc = self.meta.n_clusters[k][v]
                f_in = self.meta.feat_dim[k][v]
                f_out = self.meta.feat_dim[k][v + 1]
                r = counts[act, k, v, :kc][..., None]          # (A, kc, 1)
                src = r * cents[act, k, v, :kc, :f_in]
                if cents.device.type == "cpu":
                    # each device's kc rows through the unit on their own,
                    # as the scalar engine's propagate: the CPU's GEMM
                    # picks its kernel by the row count, so a product over
                    # every adapting device's rows rounds otherwise
                    img = torch.stack([m.unit_apply_flat(v + 1, x)
                                       for x in src])
                else:
                    img = m.unit_apply_flat(
                        v + 1, src.reshape(-1, f_in)).reshape(
                            act.numel(), kc, f_out)
                img = torch.relu(img) / r
                row = (torch.arange(kc, device=cents.device)[None, :]
                       == ci_[act][:, None])
                old = cents[act, k, v + 1, :kc, :f_out]
                cents[act, k, v + 1, :kc, :f_out] = torch.where(
                    row[..., None], img, old)
        return ServeBank(cents, counts)

    def _adapt_shared(self, bank: ServeBank, x_full, tk, u, ci, do):
        """Collaborative shared-bank update: all devices exiting at
        ``(k, u)`` this step fold into ONE :func:`km.online_update`
        (batch-averaged), then one propagation sweep refreshes every touched
        row of the deeper units.  The step's outcome arguments are lists,
        one entry per block of the fleet (one entry without a mesh): each
        block's rows are summed on its own device and the blocks' sums are
        added in block order (:func:`km.online_update_blocks`), as the
        reference's partitioned program does."""
        cents, counts = bank
        C_ = cents.shape[2]
        dev = cents.device
        iota_c = torch.arange(C_, device=dev)
        for k, m in enumerate(self.models):
            hot = torch.zeros(C_, dtype=torch.bool, device=dev)
            for v in range(m.n_units):
                kc = self.meta.n_clusters[k][v]
                fu = self.meta.feat_dim[k][v]
                mrows = [d & (t == k) & (w == v)
                         for d, t, w in zip(do, tk, u)]
                new_c, new_n = km.online_update_blocks(
                    cents[k, v, :kc, :fu], counts[k, v, :kc],
                    [x[:, :fu] for x in x_full],
                    [torch.where(mr, c, torch.full_like(c, -1))
                     for mr, c in zip(mrows, ci)],
                    weight=self.adapt_weight)
                cents[k, v, :kc, :fu] = new_c
                counts[k, v, :kc] = new_n
                if v == m.n_units - 1:
                    break
                for mr, c in zip(mrows, ci):
                    hot = hot | (mr[:, None] & (iota_c.to(c.device)[None, :]
                                                == c[:, None])).any(0).to(dev)
                f_out = self.meta.feat_dim[k][v + 1]
                r = counts[k, v, :kc, None]
                src = cents[k, v, :kc, :fu]
                img = torch.relu(m.unit_apply_flat(v + 1, r * src)) / r
                cents[k, v + 1, :kc, :f_out] = torch.where(
                    hot[:kc, None], img, cents[k, v + 1, :kc, :f_out])
        return ServeBank(cents, counts)

    # ------------------------------------------------------------------ #
    # The time loop.
    # ------------------------------------------------------------------ #

    def _scan_steps(self, cfg: FleetConfig, tables: ServeTables,
                    carry: ServeCarry, i0: int, job0=None, *,
                    statics: FleetStatics, n_steps: int,
                    adapt: bool, tel: Optional[T.Telemetry] = None,
                    tcfg: Optional[T.TelemetryConfig] = None):
        """Run ``n_steps`` live timesteps from step index ``i0``: the
        batch-polymorphic :func:`serve_step`, plus the bank adaptation from
        its aux outputs on steps where some device's utility test passed
        for the first time (a host-side check: one device sync per step).
        A shared bank has 4-D centroids; per-device request streams give
        5-D feature tables.  On the card without ``tcfg`` the steps run as
        :class:`_GraphedSteps`.

        With ``tcfg`` each step also emits the tier's telemetry columns,
        reduced into ``tel`` after the segment (the full tier's rare ring
        and histogram events folded on the host); the return is then
        ``(ServeCarry, Telemetry)``.  Tracing only adds outputs: the serve
        numerics are unchanged.  The run of one block of
        :meth:`_scan_blocks`."""
        carries, tels = self._scan_blocks(
            [cfg], [tables], [carry], i0, job0, statics=statics,
            n_steps=n_steps, adapt=adapt, tels=[tel], tcfg=tcfg)
        return carries[0] if tcfg is None else (carries[0], tels[0])

    @staticmethod
    def _x_full(tables: ServeTables, tk, u, job):
        """The full-dim feature rows of the devices' selected (task, unit,
        job): ``(D, F)``."""
        K, Ub = tables.fidx.shape[:2]
        J = tables.labels.shape[-1]
        if tables.full_feats.dim() == 5:
            return tables.full_feats[
                torch.arange(tk.shape[0], device=tk.device),
                tk.to(torch.int64), job.to(torch.int64), u.to(torch.int64)]
        ff = tables.full_feats.reshape(K * J * Ub,
                                       tables.full_feats.shape[-1])
        return S.take_rows(ff, (tk * J + job) * Ub + u)

    def _scan_blocks(self, cfgs: Sequence[FleetConfig],
                     tables: Sequence[ServeTables],
                     carries: Sequence[ServeCarry], i0: int, job0=None, *,
                     statics: FleetStatics, n_steps: int, adapt: bool,
                     tels: Sequence[Optional[T.Telemetry]],
                     tcfg: Optional[T.TelemetryConfig] = None):
        """:meth:`_scan_steps` over the blocks of a fleet cut over a mesh
        (one block without one), step by step: every block runs the step
        on its own device, in block order, and then the bank adapts.  A
        per-device bank adapts block by block; a shared bank (one copy per
        device the blocks live on, the first block's adapted and the others
        refreshed from it in place) folds every block's exits into one
        update.  Returns ``(carries, telemetries)``, one per block."""
        nb = len(cfgs)
        K = cfgs[0].period.shape[1]
        devs = [c.policy.device for c in cfgs]
        if job0 is None:
            job0 = torch.zeros(K, dtype=_I32, device=devs[0])
        job0s = [job0.to(d) for d in devs]
        dev_st = [c.dev for c in carries]
        logs = [c.log for c in carries]
        shared = carries[0].bank.centroids.dim() == 4
        trace = tcfg is not None and tcfg.level == "full"
        spec = pack_spec(cfgs[0], statics) if trace else None
        st0, ys = list(dev_st), [[] for _ in range(nb)]
        banks = [c.bank for c in carries]
        if adapt and shared:
            master = ServeBank(*[l.clone() for l in banks[0]])
            copies = {master.centroids.device: master}
            for b in banks[1:]:
                d = b.centroids.device
                if d not in copies:
                    copies[d] = ServeBank(*[l.clone() for l in b])
            banks = [copies[b.centroids.device] for b in banks]
        elif adapt:
            banks = [ServeBank(*[l.clone() for l in b]) for b in banks]
        graphs = (None if tcfg is not None or not n_steps
                  or devs[0].type != "cuda"
                  else [_GraphedSteps(c, t, ServeCarry(d, b, g), j,
                                      statics=statics)
                        for c, t, d, b, g, j in zip(cfgs, tables, dev_st,
                                                    banks, logs, job0s)])
        for i in range(i0, i0 + n_steps):
            auxes = []
            for b in range(nb):
                if graphs is not None:
                    auxes.append(graphs[b](i))
                    continue
                t = S.step_clock(i, statics.dt, devs[b])
                out = serve_step(cfgs[b], tables[b], dev_st[b], banks[b],
                                 logs[b], t, job0s[b], statics=statics,
                                 trace=trace)
                if trace:
                    ys[b].append(T_trace.emit_full(spec, out[3], dev_st[b],
                                                   out[0]))
                elif tcfg is not None:
                    ys[b].append(T_trace.emit_counters(out[0]))
                dev_st[b], logs[b] = out[0], out[1]
                auxes.append(out[2])
            if not adapt:
                continue
            hit = [bool(a[0].any()) for a in auxes]
            if not any(hit):
                continue
            x_full = [self._x_full(tb, a[1], a[2], a[3])
                      for tb, a in zip(tables, auxes)]
            if shared:
                first_pass, tk, u, _, ci = zip(*auxes)
                self._adapt_shared(master, x_full, tk, u, ci, first_pass)
                for d, copy in copies.items():
                    if copy is not master:
                        for dst, src in zip(copy, master):
                            dst.copy_(src.to(d))
                continue
            for b in range(nb):
                if hit[b]:
                    first_pass, tk, u, _, ci = auxes[b]
                    banks[b] = self._adapt_per_device(
                        banks[b], x_full[b], tk, u, ci, first_pass)
        if graphs is not None:
            dev_st = [g.dev for g in graphs]
            logs = [g.log for g in graphs]
        outs = [ServeCarry(dev=d, bank=b, log=g)
                for d, b, g in zip(dev_st, banks, logs)]
        if tcfg is None:
            return outs, [None] * nb
        new_tels = []
        for b in range(nb):
            y = [torch.stack(c) for c in zip(*ys[b])]
            if not trace:
                new_tels.append(T_trace.reduce_counters(
                    tels[b], st0[b], dev_st[b], y, n_steps))
                continue
            tel, ring = T_trace.reduce_full(spec, tels[b], st0[b], dev_st[b],
                                            y, i0, n_steps, statics.dt)
            new_tels.append(T_trace.fold_events_host(spec, tel, ring, i0,
                                                     statics.dt))
        return outs, new_tels

    # ------------------------------------------------------------------ #
    # Public entry point.
    # ------------------------------------------------------------------ #

    def _place(self, mesh, cfg, carry, tables, tel, per_dev: bool):
        """``run``'s state placed over ``mesh`` by the sharding functions:
        per block, in block order, ``(cfgs, carries, tables, tels)``."""
        D = cfg.n_devices
        if D % mesh.size:
            raise ValueError(
                f"D={D} devices must divide over mesh size {mesh.size}")
        placed = (SH.shard_fleet_config(mesh, cfg),
                  SH.shard_serve_carry(mesh, carry,
                                       shared_bank=self.bank_mode == "shared"),
                  SH.shard_serve_tables(mesh, tables, per_device=per_dev),
                  None if tel is None else SH.shard_fleet_carry(mesh, tel))
        out = [SH.blocks(x) for x in placed[:3]]
        return (*out, [None] * mesh.size if tel is None
                else SH.blocks(placed[3]))

    def _join(self, carries: Sequence[ServeCarry]) -> ServeCarry:
        """Per-block carries joined in block order (a shared bank is the
        first block's); one carry is returned as it is."""
        if len(carries) == 1:
            return carries[0]
        dev, bank, log = zip(*carries)
        return ServeCarry(
            dev=SH.join(dev), log=SH.join(log),
            bank=bank[0] if self.bank_mode == "shared" else SH.join(bank))

    def run(
        self,
        requests,
        n_devices: Optional[int] = None,
        *,
        seeds: Optional[Sequence[int]] = None,
        n_segments: int = 1,
        carry: Optional[ServeCarry] = None,
        mesh=None,
        telemetry: Optional[T.TelemetryConfig] = None,
        mode: str = "scan",
    ) -> FleetServeResult:
        """Serve every request stream live over the whole horizon.

        ``n_segments > 1`` materialises the :class:`ServeCarry` at segment
        boundaries (bit-identical to ``n_segments=1``); ``carry`` resumes
        from a previous run's carry.  ``telemetry`` (a
        :class:`repro_torch.telemetry.TelemetryConfig`) collects a ``(D,
        ...)`` telemetry through the scan into
        ``FleetServeResult.telemetry`` (the full tier's ring and histogram
        folded on the host per segment); the serve outcome is the same bit
        for bit either way.  ``mode="fused"`` runs each segment as ONE
        launch of the ``serve_fused_steps`` kernel (``adapt=False`` and no
        ``telemetry``, no ``mesh``).

        ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) places the
        config, carry, tables and telemetry by the sharding functions
        (:func:`repro_torch.launch.sharding.shard_serve_carry`; ``D`` must
        be a multiple of the mesh size) and runs the scan block by block,
        step by step (:meth:`_scan_blocks`): each block's kernel launches
        on its own device, a per-device bank's propagation convs see only
        their block's devices (as the reference's partitioned convs do),
        and a shared bank sums the blocks' partial updates in block order.
        The result's carry and telemetry are the blocks joined in order
        (the shared bank is the first block's).
        """
        if mode not in ("scan", "fused"):
            raise ValueError(f"unknown serve mode {mode!r}")
        adapt = bool(self.config.adapt)
        if mode == "fused" and adapt:
            raise ValueError(
                "mode='fused' requires adapt=False: bank adaptation "
                "propagates centroids through whole-model convs that "
                "cannot run inside a device thread")
        if mode == "fused" and (telemetry is not None or mesh is not None):
            raise ValueError(
                "mode='fused' does not support telemetry= or mesh=")
        cfg, statics, tables, carry0, per_dev = self.build(
            requests, n_devices, seeds=seeds)
        if carry is not None:
            carry0 = carry
        tel = (None if telemetry is None
               else T.init_fleet_telemetry(telemetry, cfg))
        if mesh is not None:
            cfgs, outs, tabs, tels = self._place(
                mesh, cfg, carry0, tables, tel, per_dev)
        else:
            cfgs, outs, tabs, tels = [cfg], [carry0], [tables], [tel]
        K = len(self.models)
        job0 = torch.zeros(K, dtype=_I32, device=self.device)
        sizes = [len(c) for c in
                 np.array_split(np.arange(statics.n_steps), n_segments)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        i0 = 0
        for n in sizes:
            if not n:
                continue
            if mode == "fused":
                outs = [fleet_step.serve_fused_steps(
                    cfg, outs[0], tables, i0, job0, statics=statics,
                    n_steps=n)]
            else:
                outs, tels = self._scan_blocks(
                    cfgs, tabs, outs, i0, job0, statics=statics, n_steps=n,
                    adapt=adapt, tels=tels, tcfg=telemetry)
            i0 += n
        out, tel = self._join(outs), SH.join(tels)
        fleet = finalize_fleet(SH.join(cfgs), out.dev, statics, live=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0

        log = out.log
        return FleetServeResult(
            fleet=fleet,
            units=log.units.cpu().numpy(),
            pred=log.pred.cpu().numpy(),
            correct=log.correct.cpu().numpy(),
            margin=log.margin.cpu().numpy(),
            exit_unit=log.exit_unit.cpu().numpy(),
            sched=log.sched.cpu().numpy(),
            carry=out,
            jobs=int(fleet.released.sum()),
            wall_s=wall,
            telemetry=tel,
        )

    # ------------------------------------------------------------------ #
    # Streaming: any number of jobs in O(chunk) device memory.
    # ------------------------------------------------------------------ #

    @staticmethod
    def _count_releases(period: float, horizon: float,
                        max_jobs: int) -> int:
        """``grid._n_releases``'s f64 release accumulation (including the
        ``t += period`` slip), capped by the streamed job total instead of
        ``len(profiles)``."""
        t, j = 0.0, 0
        while t < horizon and j < max_jobs:
            t += period
            j += 1
        return j

    def build_stream(
        self,
        requests,
        n_devices: Optional[int] = None,
        *,
        seeds: Optional[Sequence[int]] = None,
        total_jobs=None,
    ):
        """Like :meth:`build`, but O(1) in the total job count on the
        device.

        The grid builder gets single-job placeholder profiles (live mode
        never reads the replay tables) with ``n_releases`` overridden to
        the streamed totals; the feature/label tables stay host-side numpy,
        and :meth:`run_stream` stages a bounded window of them per chunk.
        ``total_jobs`` (int or per-task sequence, default the base stream
        length) sets how many jobs each task serves; totals beyond the
        base stream cycle it (job ``j`` serves request ``j % len(base)``).

        Returns ``(cfg, statics, base_tables, dev0, bank0, per_dev,
        totals, base_len)`` with ``base_tables`` a numpy dict.
        """
        K = len(self.models)
        D, streams, per_dev = self._streams(requests, n_devices)
        base_len = [max(len(s[k]) for s in streams) for k in range(K)]
        if any(b <= 0 for b in base_len):
            raise ValueError("every task needs at least one base request")
        if total_jobs is None:
            totals = list(base_len)
        elif np.ndim(total_jobs) == 0:
            totals = [int(total_jobs)] * K
        else:
            totals = [int(x) for x in total_jobs]

        tasks = self._task_specs([1] * K)
        fleet_cfg, statics = self._fleet_config(tasks, D, seeds)
        n_rel = np.array([self._count_releases(tasks[k].period,
                                               self.config.horizon,
                                               totals[k])
                          for k in range(K)], np.int32)
        fleet_cfg = fleet_cfg._replace(n_releases=torch.from_numpy(
            np.broadcast_to(n_rel, (D, K)).copy()).to(self.device))
        base = self._feature_tables(streams, per_dev, max(base_len))

        dev0 = init_state(fleet_cfg, statics)
        return (fleet_cfg, statics, base, dev0, self._bank0(D), per_dev,
                totals, base_len)

    def _stream_plan(self, cfg: FleetConfig, statics: FleetStatics,
                     n_chunks: int):
        """The chunks of a stream: ``(bounds, lows, Wl)`` with ``bounds``
        the ``[s0, s1)`` step range of each chunk, ``lows`` each chunk's
        first window row per task (``(K,)`` int64, negative on the first
        chunks) and ``Wl`` the window width.

        A job live during ``[t0, t1)`` must release before ``t1`` and
        expire after ``t0``; the slow-clock drift bound ``t_read = t * (1
        + drift)`` stretches lifetimes by at most ``1 + 2 * drift``, and
        two rows either side absorb the f32 release-accumulation slip."""
        K = len(self.models)
        periods = np.array(per_task(self.config.period, K), float)
        deadl = np.array(per_task(self.config.deadline, K), float)
        drift = float(cfg.clock_drift.abs().max())
        n_steps = statics.n_steps
        nc = int(max(1, min(n_chunks, max(n_steps, 1))))
        segs = [s for s in np.array_split(np.arange(n_steps), nc)
                if len(s)]
        bounds = [(int(s[0]), int(s[-1]) + 1) for s in segs]
        lows, highs = [], []
        for s0, s1 in bounds:
            t0s, t1s = s0 * statics.dt, s1 * statics.dt
            lows.append(np.floor(
                (t0s / (1.0 + 2.0 * drift) - deadl) / periods
            ).astype(np.int64) - 2)
            highs.append(np.floor(t1s / periods).astype(np.int64) + 2)
        Wl = int(max(int(np.max(h - l)) for l, h in zip(lows, highs)))
        return bounds, lows, max(Wl, 1)

    @staticmethod
    def _stage_window(base: dict, base_len, w0, Wl: int):
        """One chunk's window of the host feature/label tables: rows ``w0[k]
        .. w0[k] + Wl - 1`` of task ``k``, job ``j`` reading base request
        ``j % base_len[k]`` (numpy's remainder, so the rows before job 0,
        which are never served, wrap too).  Returns numpy ``(sel_feats,
        full_feats, labels)``."""
        idx = w0[:, None] + np.arange(Wl)[None, :]
        ps, pf, pl = [], [], []
        for k in range(len(base_len)):
            src = idx[k] % base_len[k]
            ps.append(np.take(base["sel_feats"][..., k, :, :, :], src,
                              axis=-3))
            pf.append(np.take(base["full_feats"][..., k, :, :, :], src,
                              axis=-3))
            pl.append(np.take(base["labels"][..., k, :], src, axis=-1))
        return (np.stack(ps, axis=-4), np.stack(pf, axis=-4),
                np.stack(pl, axis=-2))

    def _stream_chunks(self, cfg: FleetConfig, statics: FleetStatics,
                       base: dict, base_len, n_chunks: int):
        """The chunk protocol of :meth:`run_stream`: ``(Wl, n, chunks)``
        with ``Wl`` the log window's width, ``n`` the number of chunks and
        ``chunks`` a generator of :class:`StreamChunk`, each chunk's window
        staged from :meth:`build_stream`'s host tables and copied to the
        engine's device when it is drawn.  The caller advances its log by
        ``shift`` (:func:`_shift_log`) and then runs steps ``[s0, s1)``
        with ``job0``."""
        bounds, lows, Wl = self._stream_plan(cfg, statics, n_chunks)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        def chunks():
            prev = lows[0]
            for (s0, s1), w0 in zip(bounds, lows):
                sel, full, lab = self._stage_window(base, base_len, w0, Wl)
                shift = w0 - prev
                if (shift < 0).any():
                    raise AssertionError("job windows must advance")
                prev = w0
                t0 = time.perf_counter()
                tabs = ServeTables(sel_feats=to_dev(sel),
                                   full_feats=to_dev(full),
                                   labels=to_dev(lab), **self._bank_tables)
                j0 = to_dev(w0.astype(np.int32))
                sh = to_dev(shift.astype(np.int32))
                yield StreamChunk(s0, s1, w0, tabs, j0, sh,
                                  time.perf_counter() - t0)

        return Wl, len(bounds), chunks()

    def run_stream(
        self,
        requests,
        n_devices: Optional[int] = None,
        *,
        seeds: Optional[Sequence[int]] = None,
        total_jobs=None,
        n_chunks: int = 1,
        mode: str = "scan",
        telemetry: Optional[T.TelemetryConfig] = None,
    ) -> FleetServeResult:
        """Serve a job stream of any length with O(chunk) device memory.

        The horizon is split into ``n_chunks`` step ranges; each chunk
        stages only the bounded window of per-job feature/label rows its
        steps can touch (from periods, deadlines and clock drift), copies
        it to the engine's device, rebases job ids with ``job0`` (signed:
        negative on the first chunks) and advances the log window.  One
        carry is live at a time; the full per-job log is assembled on the
        host.  Bit-exact against :meth:`run` on the same requests for any
        chunking.  ``total_jobs`` streams past the base request list by
        cycling it, which is how one call serves millions of jobs.
        ``mode="fused"`` runs each chunk as ONE launch of the
        ``serve_fused_steps`` kernel (``adapt=False`` only).  ``compile_s``
        is always 0: nothing is compiled ahead of the run.  ``telemetry``
        supports the ``"counters"`` tier (the full tier's ring fold is
        per-run host state: use :meth:`run`); the fused mode rejects it.
        """
        cfg_s = self.config
        adapt = bool(cfg_s.adapt)
        if mode not in ("scan", "fused"):
            raise ValueError(f"unknown serve mode {mode!r}")
        if mode == "fused" and telemetry is not None:
            raise ValueError(
                "mode='fused' requires adapt=False and no telemetry")
        if telemetry is not None and telemetry.level == "full":
            raise ValueError(
                "run_stream supports the 'counters' telemetry tier only")
        if mode == "fused" and adapt:
            raise ValueError(
                "mode='fused' requires adapt=False: bank adaptation "
                "propagates centroids through whole-model convs that "
                "cannot run inside a device thread")
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)

        (fleet_cfg, statics, base, dev0, bank0, per_dev, totals,
         base_len) = self.build_stream(requests, n_devices, seeds=seeds,
                                       total_jobs=total_jobs)
        D = int(fleet_cfg.policy.shape[0])
        K = len(self.models)
        Wl, n_run, chunks = self._stream_chunks(fleet_cfg, statics, base,
                                                base_len, n_chunks)
        carry = ServeCarry(dev=dev0, bank=bank0, log=self.log0(D, Wl))
        tel = (None if telemetry is None
               else T.init_fleet_telemetry(telemetry, fleet_cfg))

        Jt = max(max(totals), 1)
        full_log = dict(
            units=np.zeros((D, K, Jt), np.int32),
            pred=np.full((D, K, Jt), -1, np.int32),
            correct=np.zeros((D, K, Jt), bool),
            margin=np.zeros((D, K, Jt), np.float32),
            exit_unit=np.full((D, K, Jt), -1, np.int32),
            sched=np.zeros((D, K, Jt), bool),
        )

        wall = 0.0
        chunk_bytes = 0
        win_cols = np.arange(Wl)
        for ch in chunks:
            t_r = time.perf_counter()
            carry = carry._replace(log=_shift_log(carry.log, ch.shift))
            if mode == "fused":
                carry = fleet_step.serve_fused_steps(
                    fleet_cfg, carry, ch.tables, ch.s0, ch.job0,
                    statics=statics, n_steps=ch.s1 - ch.s0)
            elif tel is None:
                carry = self._scan_steps(
                    fleet_cfg, ch.tables, carry, ch.s0, ch.job0,
                    statics=statics, n_steps=ch.s1 - ch.s0, adapt=adapt)
            else:
                carry, tel = self._scan_steps(
                    fleet_cfg, ch.tables, carry, ch.s0, ch.job0,
                    statics=statics, n_steps=ch.s1 - ch.s0, adapt=adapt,
                    tel=tel, tcfg=telemetry)
            if on_card:
                torch.cuda.synchronize(self.device)
            wall += time.perf_counter() - t_r + ch.copy_s
            chunk_bytes = max(chunk_bytes, sum(
                l.numel() * l.element_size() for l in ch.tables))
            win = {f: getattr(carry.log, f).cpu().numpy()
                   for f in ServeLog._fields}
            for k in range(K):
                cols = ch.w0[k] + win_cols
                ok = (cols >= 0) & (cols < totals[k])
                if ok.any():
                    for f in full_log:
                        full_log[f][:, k, cols[ok]] = win[f][:, k, ok]

        t_r = time.perf_counter()
        fleet = finalize_fleet(fleet_cfg, carry.dev, statics, live=True)
        if on_card:
            torch.cuda.synchronize(self.device)
        wall += time.perf_counter() - t_r
        return FleetServeResult(
            fleet=fleet,
            units=full_log["units"],
            pred=full_log["pred"],
            correct=full_log["correct"],
            margin=full_log["margin"],
            exit_unit=full_log["exit_unit"],
            sched=full_log["sched"],
            carry=carry,
            jobs=int(fleet.released.sum()),
            wall_s=wall,
            telemetry=tel,
            peak_bytes=(int(torch.cuda.max_memory_allocated(self.device))
                        if on_card else 0),
            chunk_table_bytes=chunk_bytes,
            n_chunks=n_run,
        )
