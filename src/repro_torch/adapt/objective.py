"""Batched fleet-sweep objectives for scheduler-parameter tuning (port of
:mod:`repro.adapt.objective`).

:class:`TuneProblem` freezes everything about the deployment that is *not*
being tuned — the task workload, the harvester patterns, capacitor, seeds,
horizon — and exposes :meth:`TuneProblem.objective`: a callable that scores a
whole population of candidate scheduler parameters with ONE
:func:`repro_torch.fleet.simulator.simulate_fleet` call in ``fused`` mode,
i.e. one launch of the ``fleet_fused_steps`` kernel on a card (its plain
version on the CPU).

The base config holds one device per (harvester pattern x seed) cell; a
population of N candidates tiles it to ``N * cells`` devices, overrides the
tuned fields (eta, E_opt, per-unit exit thresholds) per candidate, simulates
the whole block, and reduces each candidate's cells to a scalar with
:func:`repro_torch.core.utility.scalarized_objective` and a mean over the
cells taken in the reference's order.

Recognised parameter names:

* ``eta``             — the Eq. 7 energy-gate weight.
* ``e_opt_fraction``  — E_opt as a fraction of capacitor capacity.
* ``exit_threshold``  — one utility-test threshold shared by all units of
  every task.
* ``exit_thr_<u>``        — unit-``u`` threshold, shared by every task.
* ``exit_thr_t<k>``       — one threshold for all units of task ``k``.
* ``exit_thr_t<k>_u<u>``  — the (task ``k``, unit ``u``) threshold cell.

Unset cells fall back to the base config's threshold table.
``task_weights`` scalarizes the per-task metric columns instead of the
aggregate counts.  ``mesh=`` cuts each block's devices over a
:class:`repro_torch.launch.mesh.Mesh` (:func:`repro_torch.fleet.simulator
.simulate_fleet_sharded`, one launch of the fused kernel per mesh device)
and reduces the scores after the join, so the sharded objective equals
the unsharded one bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core._fma import fma_f32
from ..core.energy import Capacitor, Harvester, eta_factor
from ..core.scheduler import TaskSpec
from ..fleet import grid as fgrid
from ..fleet.simulator import simulate_fleet_sharded
from ..fleet.state import FleetConfig, FleetStatics
from ..kernels.l1_topk2 import ordered_sum

# The constants the paper (and this repo's SimConfig) defaults to: E_opt at
# 70% of capacity, eta measured from the harvester trace (Eq. 3).
PAPER_E_OPT_FRACTION = 0.7

Objective = Callable[[Mapping[str, np.ndarray]], np.ndarray]


def _parse_exit_thr_name(suffix: str) -> tuple[Optional[int], Optional[int]]:
    """``exit_thr_`` suffix -> (task, unit); None selects the whole axis.

    ``"2"`` -> (None, 2); ``"t1"`` -> (1, None); ``"t1_u3"`` -> (1, 3).
    """
    if suffix.isdigit():
        return None, int(suffix)
    if suffix.startswith("t"):
        task_part, _, unit_part = suffix[1:].partition("_")
        if task_part.isdigit() and not unit_part:
            return int(task_part), None
        if (task_part.isdigit() and unit_part.startswith("u")
                and unit_part[1:].isdigit()):
            return int(task_part), int(unit_part[1:])
    raise KeyError(f"malformed exit_thr parameter suffix {suffix!r}")


def apply_params(cfg: FleetConfig, params: Mapping[str, object]
                 ) -> FleetConfig:
    """Thread tuned parameter arrays into a FleetConfig, one value per
    device.  Values may be numpy arrays or tensors; they become float32 on
    the config's device.  The config is never written: every updated field
    is a new contiguous tensor.  Exit-threshold names address cells of the
    ``(D, K, U)`` per-task threshold table (see the module docstring); an
    index past the table's end updates nothing, as the reference's
    ``.at[...].set`` drops it.
    """
    dev = cfg.eta.device
    upd: dict = {}
    exit_thr = cfg.exit_thr
    tune_thr = False
    for name, v in params.items():
        v = torch.as_tensor(v, device=dev).to(torch.float32)
        if name == "eta":
            eta = torch.broadcast_to(v, cfg.eta.shape).contiguous()
            upd["eta"] = eta
            # the persistent fast path (Eq. 6) requires BOTH a persistent
            # harvester and eta >= 1; the base flag already encodes the
            # harvester half, so a tuned eta can only narrow it
            upd["persistent"] = cfg.persistent & (eta >= 1.0)
        elif name == "e_opt_fraction":
            upd["e_opt"] = torch.broadcast_to(v, cfg.eta.shape) * cfg.capacity
        elif name == "exit_threshold":
            exit_thr = torch.broadcast_to(v[..., None, None],
                                          exit_thr.shape).contiguous()
            tune_thr = True
        elif name.startswith("exit_thr_"):
            task, unit = _parse_exit_thr_name(name[len("exit_thr_"):])
            exit_thr = exit_thr.clone()
            _, k_max, u_max = exit_thr.shape
            if task is None:
                if unit < u_max:
                    exit_thr[:, :, unit] = v[:, None]
            elif unit is None:
                if task < k_max:
                    exit_thr[:, task, :] = v[:, None]
            elif task < k_max and unit < u_max:
                exit_thr[:, task, unit] = v
            tune_thr = True
        else:
            raise KeyError(f"unknown tunable parameter {name!r}")
    if tune_thr:
        upd["exit_thr"] = exit_thr
        upd["use_exit_thr"] = torch.ones_like(cfg.use_exit_thr)
    return cfg._replace(**upd)


def _tile(leaf: torch.Tensor, n: int) -> torch.Tensor:
    """``(d0, ...)`` -> ``(n * d0, ...)``: the whole block ``n`` times,
    candidate-major."""
    return leaf.repeat((n,) + (1,) * (leaf.dim() - 1))


# --------------------------------------------------------------------------- #
# The score as the reference's compiled objective computes it.
#
# The reference scores a block inside one jitted program in which the base
# config is a compile-time constant.  XLA on the CPU then (1) folds the
# aggregate ``released`` count (a sum of the constant ``n_releases``) and
# rewrites ``x / released`` as ``x * (1 / released)``, and the miss weight
# into that reciprocal; (2) divides the per-task columns by their constant
# ``(D, K)`` table as written; (3) rewrites the mean's ``/ d0`` as
# ``* (1 / d0)``; (4) contracts every product into the add or subtract
# that consumes it in the same loop body (one rounding), the cell sum's
# accumulator included, so the products of one cell's score chain into it;
# and (5) orders the cell sum by its length: windows of 32 beyond 32
# cells, else in order — except that the one-task loop is vectorised at
# 4, 8, 16 or 32 cells: two interleaved accumulators of 4 lanes, added,
# then a tree.  A block of one candidate
# with task weights sums its (cell, task) terms in one pass.  Only a
# one-task aggregate gets (1): with more tasks ``released`` is summed at
# run time.  The helpers below form exactly that, read off the optimised IR
# of the reference objective and checked at 4, 6, 8, 10, 12, 16, 32, 36
# and 48 cells.
# --------------------------------------------------------------------------- #


def _f32(x: float) -> float:
    return float(np.float32(x))


def _chain(terms, acc: torch.Tensor) -> torch.Tensor:
    """``acc`` plus each product ``a * b`` of ``terms`` in turn, every
    product fused into its add (one rounding each)."""
    for a, b in terms:
        acc = fma_f32(a, b, acc)
    return acc


def _cell_sum(terms, lanes: bool = False) -> torch.Tensor:
    """The sum over the last (cell) axis of the per-cell scores
    ``sum_t a_t * b_t`` (``terms``: ``(a, b)`` pairs shaped
    ``(n, cells)``), in the compiled reference's order (see above);
    ``lanes``: the loop is vectorised (a one-task score)."""
    a0 = terms[0][0]
    n = a0.shape[-1]
    zero = torch.zeros(a0.shape[:-1], dtype=torch.float32, device=a0.device)
    if n > 32:
        # windows of 32 over the rounded per-cell scores
        cell = _chain(terms, torch.zeros_like(a0))
        return ordered_sum(cell)
    if lanes and n >= 4 and n & (n - 1) == 0:
        # two interleaved accumulators of 4 lanes (cells 0-3 into the
        # first, 4-7 into the second, ...), each lane chaining its cells'
        # products; then the two added lane by lane, then a tree
        acc = [[zero] * 4, [zero] * 4]
        for c in range(n):
            u, lane = (c // 4) % 2, c % 4
            acc[u][lane] = _chain([(a[..., c], b[..., c]) for a, b in terms],
                                  acc[u][lane])
        v = [acc[0][lane] + acc[1][lane] for lane in range(4)]
        return (v[0] + v[2]) + (v[1] + v[3])
    acc = zero
    for c in range(n):
        acc = _chain([(a[..., c], b[..., c]) for a, b in terms], acc)
    return acc


def _compiled_scores(res, d0: int, miss_weight: float,
                     optional_weight: float,
                     task_w: Optional[torch.Tensor]) -> torch.Tensor:
    """The ``(n,)`` candidate scores of a block of ``n * d0`` devices:
    :func:`repro_torch.core.utility.scalarized_objective` per device (or
    per task, weighted across the task set), then the mean over each
    candidate's ``d0`` cells — with the arithmetic of the compiled
    reference objective."""
    f32 = torch.float32
    n = res.released.shape[0] // d0
    inv_d0 = 1.0 / torch.tensor(float(d0), dtype=f32,
                                device=res.released.device)
    if task_w is None and res.task_released.shape[1] == 1:
        # one task: ``released`` is a folded constant, so the score is a
        # chain of products, fused one by one into the cell sum
        inv = 1.0 / torch.clamp(res.released.to(f32), min=1.0)
        terms = [(res.correct.to(f32), inv)]
        if miss_weight:
            k = inv * _f32(miss_weight)
            terms.insert(0, (-res.deadline_misses.to(f32), k))
        if optional_weight:
            units = torch.clamp(res.units_executed.to(f32), min=1.0)
            q = res.optional_units.to(f32) / units
            w = torch.full_like(q, _f32(optional_weight))
            if miss_weight:
                terms.append((q, w))
            else:
                terms.insert(0, (q, w))
        terms = [(a.reshape(n, d0), b.reshape(n, d0)) for a, b in terms]
        return _cell_sum(terms, lanes=True) * inv_d0
    if task_w is None:
        counts = (res.correct, res.released, res.deadline_misses,
                  res.optional_units, res.units_executed)
    else:
        counts = (res.task_correct, res.task_released, res.task_misses,
                  res.task_optional, res.task_units)
    correct, released, misses, optional, units = (x.to(f32) for x in counts)
    rel = torch.clamp(released, min=1.0)
    val = correct / rel
    if miss_weight:
        val = fma_f32(-_f32(miss_weight), misses / rel, val)
    if optional_weight:
        val = fma_f32(optional / torch.clamp(units, min=1.0),
                      _f32(optional_weight), val)
    if task_w is None:
        one = torch.ones_like(val)
        return _cell_sum([(val.reshape(n, d0), one.reshape(n, d0))]) * inv_d0
    if n == 1:
        # one candidate: the task and cell sums merge into one sum over
        # the (cell, task) terms, in order
        flat, w = val.reshape(-1), task_w.repeat(d0)
        acc = torch.zeros((), dtype=f32, device=val.device)
        for t in range(flat.shape[0]):
            acc = fma_f32(flat[t], w[t], acc)
        return acc.reshape(1) * inv_d0
    score = _chain([(val[:, k], task_w[k].expand(val.shape[0]))
                    for k in range(val.shape[1])],
                   torch.zeros(val.shape[0], dtype=f32, device=val.device))
    one = torch.ones_like(score)
    return _cell_sum([(score.reshape(n, d0), one.reshape(n, d0))]) * inv_d0


@dataclasses.dataclass(frozen=True)
class TuneProblem:
    """A fixed deployment whose scheduler parameters are to be tuned.

    ``task`` accepts one :class:`TaskSpec` or a whole task set (any
    sequence) — each simulated device then runs all ``K`` streams against
    one shared energy budget, and ``task_weights`` (length ``K``) switches
    the objective from the aggregate on-time accuracy to a weighted mean of
    the per-task accuracies.  The fleet lives on ``device`` (default
    ``"cuda"``)."""

    task: fgrid.TaskSet
    harvesters: Sequence[Harvester]
    capacitor: Capacitor = dataclasses.field(default_factory=Capacitor)
    seeds: Sequence[int] = (0, 1)
    policy: str = "zygarde"
    horizon: float = 60.0
    queue_size: int = 3
    dt: Optional[float] = None          # default: one fragment time
    start_charged: bool = False
    clock_drift: float = 0.0            # fleet CHRT drift rate
    miss_weight: float = 0.0            # scalarization penalties
    optional_weight: float = 0.0
    # per-task scalarization weights, (K,); None = aggregate counts
    task_weights: Optional[Sequence[float]] = None
    # base per-unit utility-test thresholds, (U,) shared or (K, U) per task
    exit_thresholds: Optional[Sequence[float]] = None
    # cuts each block's devices over a launch.mesh.Mesh
    mesh: Optional[object] = None
    device: object = "cuda"

    @property
    def tasks(self) -> tuple[TaskSpec, ...]:
        return fgrid.as_task_set(self.task)

    @property
    def n_cells(self) -> int:
        return len(self.harvesters) * len(self.seeds)

    @functools.cached_property
    def _base(self) -> tuple[FleetConfig, FleetStatics]:
        """One device per (harvester, seed) cell, paper-default parameters."""
        if not self.harvesters:
            raise ValueError("TuneProblem needs at least one harvester")
        tasks = self.tasks
        if self.task_weights is not None and (
                len(self.task_weights) != len(tasks)):
            raise ValueError("task_weights length must match the task set")
        slot_lens = {h.slot_s for h in self.harvesters}
        if len(slot_lens) != 1:
            raise ValueError("all harvesters in one problem must share slot_s")
        dt = self.dt
        if dt is None:
            dt = min(float(np.min(np.asarray(t.unit_time))
                           / t.fragments_per_unit) for t in tasks)
        etas = self._measured_etas()
        devices = []
        for h, eta in zip(self.harvesters, etas):
            for s in self.seeds:
                devices.append(fgrid.device_config(
                    tasks, h, eta, self.capacitor,
                    policy=self.policy, horizon=self.horizon,
                    events=fgrid.sample_events(h, self.horizon, s),
                    e_opt_fraction=PAPER_E_OPT_FRACTION,
                    start_charged=self.start_charged,
                    clock_drift=self.clock_drift,
                    exit_thresholds=self.exit_thresholds,
                ))
        statics = FleetStatics(queue_size=self.queue_size, dt=dt,
                               horizon=self.horizon, slot_s=slot_lens.pop())
        return fgrid.stack_configs(devices, self.device), statics

    def _measured_etas(self) -> list[float]:
        """Eq. 3 eta measured from each harvester's event stream."""
        return [
            eta_factor(h.sample_events(np.random.default_rng(0), 4000,
                                       init=1))
            for h in self.harvesters
        ]

    def default_params(self) -> dict[str, float]:
        """The paper-default operating point: eta measured from the
        harvester event streams (Eq. 3, averaged over patterns) and
        E_opt = 0.7 x capacity."""
        return {"eta": float(np.mean(self._measured_etas())),
                "e_opt_fraction": PAPER_E_OPT_FRACTION}

    def objective(self) -> Objective:
        """The batched objective: ``{name: (N,)} -> (N,) scores`` (higher is
        better), one fleet simulation per call."""
        return self._objective_fn

    def _evaluate(self, params: Mapping[str, np.ndarray]) -> torch.Tensor:
        """Score one block of ``n`` candidates as given (no bucketing):
        ``(n,)`` float32 scores on the problem's device (under a mesh, the
        mesh's first device)."""
        base, statics = self._base
        d0 = base.n_devices
        dev = base.eta.device
        n = next(iter(params.values())).shape[0]
        cfg = FleetConfig(*[_tile(leaf, n) for leaf in base])
        cfg = apply_params(cfg, {
            k: torch.as_tensor(np.asarray(v, np.float32), device=dev
                               ).repeat_interleave(d0)
            for k, v in params.items()})
        res = simulate_fleet_sharded(cfg, statics, mesh=self.mesh,
                                     mode="fused")
        dev = res.released.device
        task_w = None if self.task_weights is None else self._task_w.to(dev)
        return _compiled_scores(res, d0, self.miss_weight,
                                self.optional_weight, task_w)

    @functools.cached_property
    def _task_w(self) -> torch.Tensor:
        w = torch.tensor(np.asarray(self.task_weights, np.float32))
        return w / ordered_sum(w)

    @functools.cached_property
    def _objective_fn(self) -> Objective:
        def objective_fn(params: Mapping[str, np.ndarray]) -> np.ndarray:
            arrs = {k: np.atleast_1d(np.asarray(v, np.float32))
                    for k, v in params.items()}
            n = next(iter(arrs.values())).shape[0]
            # bucket block sizes to powers of two, as the reference does:
            # it fixes which padded rows exist; the real rows' scores do
            # not depend on them
            n_pad = 1 << (n - 1).bit_length() if n > 1 else 1
            if self.mesh is not None:
                # whole blocks: the devices divide over the mesh unpadded
                while (n_pad * self.n_cells) % self.mesh.size:
                    n_pad += 1
            if n_pad != n:
                arrs = {k: np.concatenate([v, np.repeat(v[:1], n_pad - n)])
                        for k, v in arrs.items()}
            return self._evaluate(arrs).cpu().numpy()[:n]

        objective_fn.problem = self
        return objective_fn

    def score(self, params: Mapping[str, float]) -> float:
        """Score one operating point (e.g. :meth:`default_params`)."""
        return float(self.objective()(
            {k: np.asarray([v], np.float32) for k, v in params.items()})[0])
