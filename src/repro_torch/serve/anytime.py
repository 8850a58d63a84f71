"""Deadline-aware anytime serving of the model configs (port of
:mod:`repro.serve.anytime`).

Continuous batching + Zygarde imprecise computation: every step the engine
admits released requests into free batch slots (priority-ordered by the
paper's zeta_I — Eq. 7 — or by EDF), runs ONE batched
:func:`repro_torch.models.anytime.unit_decode_step` over all slots, and
picks a per-request *depth* for accounting:

* ``policy="anytime"`` — the margin utility test proposes a depth; a
  deadline cap (greedy per-token latency budget) and the Eq. 7 energy gate
  (``eta * energy >= E_opt``) can force it down to the mandatory prefix;
  the result is clamped to ``[mandatory, U]``.
* ``policy="edf"`` — fixed full depth (the precise-computation baseline).
* ``policy="edf-m"`` — fixed mandatory depth (maximal imprecision).

A step costs ``t_base + unit_time * max(depth)`` seconds; energy flows
through a capacitor fed by a harvester's power trace, and a step whose
store cannot cover ``e_base`` is a brownout (no compute, time passes).

How the port runs the reference's jitted scan eagerly:

* The brownout branch (the reference's ``lax.cond(on, run_model,
  skip_model)``) runs the model every step and selects with
  :func:`torch.where`: ``skip_model`` gives zero logits and the unchanged
  state, so the results are the same, and no step waits on a host sync
  (a Python ``if`` on a device flag would stall the card's queue once per
  step).  A brownout step therefore costs model time on the card.
* The admission loop and every other data-dependent choice are tensor ops
  too; the run syncs with the host only when it returns.
* The scalar clock and energy arithmetic is the reference's as XLA on the
  CPU compiles it (read off the optimised IR of the jitted segment, the
  tests' engine: 2 slots, 6 requests): ``dt = t_base + unit_time * d`` is
  one fused multiply-add, and so is the capacitor update ``(energy -
  consume) + trace * dt``; ``consume = e_base * any + unit_energy * sum(d)``
  is fused under ``anytime`` but not under ``edf``/``edf-m`` (there LLVM
  hoists the product out of the depth sum's branch); the deadline cap's
  ``/ unit_time`` is a multiply by the f32 reciprocal, and zeta_I with
  ``utility = 0`` and ``mandatory = 1`` folds to ``3 - alpha * laxity``
  (gate open) or ``2 - alpha * laxity``; the EDF key's ``1e-9 * release``
  is its own rounding.  The result arrays then match the reference bit for
  bit (``tests/test_torch_anytime.py``).
* ``score_fn`` evaluates one candidate per engine run (the reference vmaps
  the scan over the candidate population).
* ``telemetry=`` folds each step into a :class:`repro_torch.telemetry
  .Telemetry` on the engine's device (:func:`~repro_torch.telemetry
  .record_anytime_step`: admissions, on-time and late completions, the
  per-token depth histogram, slack, busy slots, energy); the result
  arrays are the same bit for bit either way.
* ``mesh=`` places the decode state by
  :func:`repro_torch.launch.sharding.state_specs` (the reference's split:
  slots over ``data``; kv heads, or the cache length where they do not
  divide, and the RG-LRU width over ``model``) and runs each step's model
  block by block (:func:`repro_torch.models.transformer.block_step` on a
  placed state).  Admission, depth control, the clock and the energy gate
  stay whole: they are per-slot scalars, and the rows each block resets or
  keeps are its slice of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import energy as EN
from ..core import policy as POL
from ..core._fma import fma_f32
from ..models import anytime as A
from ..models import transformer as T
from ..models.common import (Sharded, block_layout, place_like,
                             replace_blocks, whole_of)
from ..telemetry import state as TEL

_F32 = torch.float32
_I32 = torch.int32

__all__ = [
    "AnytimeConfig", "AnytimeKnobs", "AnytimeRequest", "AnytimeTables",
    "AnytimeCarry", "AnytimeResult", "AnytimeServeEngine",
]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip(x: float) -> float:
    """``1 / x`` as XLA folds a division by a constant: in f32."""
    return float(np.float32(1.0) / np.float32(x))


# --------------------------------------------------------------------------- #
# Configuration, knobs, requests.
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class AnytimeConfig:
    """Static engine configuration.

    Latency model: a step costs ``t_base + unit_time * max(depth)``
    seconds; energy: ``e_base`` per non-idle step plus ``unit_energy`` per
    unit of charged depth per slot, drawn from a capacitor of ``capacity``
    joules refilled by the supply trace (``trace_dt`` seconds per trace
    slot).  ``mandatory_units=0`` defers to the model config's
    ``resolved_mandatory_units``.
    """

    policy: str = "anytime"       # "anytime" | "edf" | "edf-m"
    batch_slots: int = 4          # continuous-batching slots (B)
    max_steps: int = 256          # horizon in steps (T)
    prompt_len: int = 4           # prompt table width (P)
    max_new_tokens: int = 16      # per-request generation cap
    alpha: float = 0.1            # zeta laxity weight
    beta: float = 0.5             # zeta utility weight
    t_base: float = 0.02          # per-step fixed latency (s)
    unit_time: float = 0.05       # latency per unit of depth (s)
    e_base: float = 0.05          # energy per non-idle step (J)
    unit_energy: float = 0.1      # energy per unit of depth per slot (J)
    capacity: float = 50.0        # capacitor size (J)
    start_frac: float = 1.0       # initial charge fraction
    trace_dt: float = 1.0         # seconds per supply-trace slot
    mandatory_units: int = 0      # 0 => model config's mandatory prefix
    deadline_cap: bool = True     # anytime: laxity-budget depth cap
    window: Optional[int] = None  # attention window override

    def __post_init__(self):
        if self.policy not in ("anytime", "edf", "edf-m"):
            raise ValueError(f"unknown policy {self.policy!r}")


class AnytimeKnobs(NamedTuple):
    """Dynamic scheduler knobs."""

    exit_thr: torch.Tensor      # (U,) f32 per-unit margin thresholds
    use_exit_thr: torch.Tensor  # (U,) f32 0/1 per-unit enables
    eta: torch.Tensor           # () f32 harvest-predictability factor
    e_opt: torch.Tensor         # () f32 optional-work energy gate (J)


@dataclass(frozen=True)
class AnytimeRequest:
    """One serving request: prompt tokens, generation budget, timing."""

    prompt: Sequence[int]
    n_tokens: int
    release: float
    deadline: float


class AnytimeTables(NamedTuple):
    """Packed request tables (device tensors)."""

    prompt: torch.Tensor      # (N, P) i32
    prompt_len: torch.Tensor  # (N,) i32
    n_tokens: torch.Tensor    # (N,) i32
    release: torch.Tensor     # (N,) f32
    deadline: torch.Tensor    # (N,) f32


class AnytimeCarry(NamedTuple):
    """The engine's state between steps."""

    now: torch.Tensor         # () f32 simulation clock
    energy: torch.Tensor      # () f32 capacitor charge
    state: Any                # stacked=False decode state for B slots
    slot_req: torch.Tensor    # (B,) i32 request index, -1 = free
    slot_next: torch.Tensor   # (B,) i32 next input token per slot
    req_status: torch.Tensor  # (N,) i32 0 wait / 1 run / 2 on-time / 3 late
    req_finish: torch.Tensor  # (N,) f32 completion time (0 until retired)
    req_agree: torch.Tensor   # (N,) i32 tokens agreeing with full depth
    req_tokens: torch.Tensor  # (N,) i32 tokens generated
    req_depth: torch.Tensor   # (N,) i32 summed depth over generated tokens
    tel: Any = None           # Telemetry, or None when it is off


# --------------------------------------------------------------------------- #
# Results.
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class AnytimeResult:
    """Host-side per-request outcome + summary metrics.

    ``score`` is the fraction of *requested* tokens that were generated by
    an on-time request AND agree with the full-depth prediction.
    """

    status: np.ndarray     # (N,) final req_status
    finish: np.ndarray     # (N,) completion time (horizon if unfinished)
    tardiness: np.ndarray  # (N,) max(0, finish - deadline)
    agree: np.ndarray      # (N,) tokens agreeing with full depth
    tokens: np.ndarray     # (N,) tokens generated
    depth_sum: np.ndarray  # (N,) summed depth over generated tokens
    requested: np.ndarray  # (N,) tokens requested
    horizon: float         # simulation end time
    n_units: int
    telemetry: Any = None

    @property
    def n_requests(self) -> int:
        return int(self.status.size)

    @property
    def completed(self) -> int:
        return int((self.status >= 2).sum())

    @property
    def on_time(self) -> int:
        return int((self.status == 2).sum())

    @property
    def missed(self) -> int:
        """Late completions + requests unfinished at the horizon."""
        return self.n_requests - self.on_time

    @property
    def mean_depth(self) -> float:
        return float(self.depth_sum.sum() / max(int(self.tokens.sum()), 1))

    @property
    def agreement(self) -> float:
        return float(self.agree.sum() / max(int(self.tokens.sum()), 1))

    @property
    def mean_tardiness(self) -> float:
        return float(self.tardiness.mean()) if self.tardiness.size else 0.0

    @property
    def score(self) -> float:
        good = np.where(self.status == 2, self.agree, 0)
        return float(good.sum() / max(int(self.requested.sum()), 1))

    def as_dict(self) -> dict:
        return {
            "n_requests": self.n_requests, "completed": self.completed,
            "on_time": self.on_time, "missed": self.missed,
            "mean_depth": self.mean_depth, "agreement": self.agreement,
            "mean_tardiness": self.mean_tardiness, "score": self.score,
            "horizon": self.horizon,
        }


# --------------------------------------------------------------------------- #
# The engine.
# --------------------------------------------------------------------------- #


def _bmask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B,) mask over a batch-leading leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.dim() - 1))


def _where_rows(mask: torch.Tensor, new, old):
    """``torch.where`` of a ``(B,)`` row mask (or a scalar) over a
    batch-leading leaf; a leaf placed over a mesh takes each block's rows
    of the mask on the block's device."""
    if not isinstance(old, Sharded):
        return torch.where(_bmask(mask, old) if mask.dim() else mask, new,
                           old)
    out = list(old.blocks)
    for sl, idx in block_layout(old):
        for i in idx:
            m = (mask[sl[0]] if mask.dim() else mask).to(out[i].device)
            out[i] = torch.where(_bmask(m, out[i]) if m.dim() else m,
                                 new.blocks[i], out[i])
    return replace_blocks(old, out)


def _map_state(fn, *states):
    """``fn`` over the leaves of decode states of one structure."""
    first = states[0]
    if isinstance(first, dict):
        return {k: _map_state(fn, *[s[k] for s in states]) for k in first}
    if isinstance(first, tuple):
        return tuple(_map_state(fn, *xs) for xs in zip(*states))
    return fn(*states)


def _set_at(values: torch.Tensor, idx: torch.Tensor, new) -> torch.Tensor:
    """``values.at[idx].set(new, mode="drop")``: indices ``>= len`` drop."""
    n = values.shape[0]
    out = torch.cat([values, values[:1]])
    if not isinstance(new, torch.Tensor):
        new = values.new_full(idx.shape, new)
    out[idx.long()] = new
    return out[:n]


def _add_at(values: torch.Tensor, idx: torch.Tensor,
            add: torch.Tensor) -> torch.Tensor:
    """``values.at[idx].add(add, mode="drop")``."""
    n = values.shape[0]
    out = torch.cat([values, values[:1]])
    out.index_add_(0, idx.long(), add.to(values.dtype))
    return out[:n]


class AnytimeServeEngine:
    """Continuous-batching anytime engine for any model config (admission
    resets every leaf of a slot's decode state: KV caches, recurrent and
    xLSTM cells, an encoder-decoder's ``enc_out`` and cross keys and values,
    which stay zero as in the reference's engine).

    ``supply`` is a :class:`repro_torch.core.energy.Harvester` (its power
    trace is sampled with ``seed``), a precomputed watts array, or ``None``
    for an always-ample persistent source.  The engine runs on the device
    of ``params``.
    """

    def __init__(self, cfg, params, heads=None, *,
                 serve_cfg: AnytimeConfig = AnytimeConfig(),
                 supply=None, seed: int = 0):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.heads = (heads if heads is not None
                      else A.init_heads(cfg, device=self.device))
        self.scfg = serve_cfg
        self.n_units = cfg.n_units
        self.mandatory = (serve_cfg.mandatory_units
                          or cfg.resolved_mandatory_units)
        if not 1 <= self.mandatory <= self.n_units:
            raise ValueError(
                f"mandatory_units {self.mandatory} outside [1, "
                f"{self.n_units}]")
        sc = serve_cfg
        horizon = sc.max_steps * (sc.t_base + sc.unit_time * self.n_units)
        if supply is None:
            # persistent: always refill faster than the worst-case burn
            burn = (sc.e_base + sc.batch_slots * sc.unit_energy
                    * self.n_units) / max(sc.t_base, 1e-9)
            trace = np.full(1, burn, np.float64)
        elif isinstance(supply, EN.Harvester):
            n_slots = int(np.ceil(horizon / sc.trace_dt)) + 1
            trace = supply.power_trace(
                np.random.default_rng(seed), n_slots)
        else:
            trace = np.asarray(supply, np.float64)
        self.trace = torch.as_tensor(trace.astype(np.float32),
                                     device=self.device)
        self._cache_len = sc.prompt_len + sc.max_new_tokens
        self._zero_state = T.init_decode_state(
            cfg, sc.batch_slots, self._cache_len, window=sc.window,
            cache_len=self._cache_len, stacked=False, device=self.device)

    # ------------------------------------------------------------------ #
    def _tensor(self, x, dtype=_F32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=self.device).to(dtype)

    def default_knobs(self, *, exit_thr=None, use_exit_thr=None,
                      eta: float = 1.0,
                      e_opt_fraction: float = 0.25) -> AnytimeKnobs:
        U = self.n_units
        if exit_thr is None:
            exit_thr = np.full((U,), self.cfg.utility_threshold, np.float32)
        if use_exit_thr is None:
            use_exit_thr = np.ones((U,), np.float32)
        return AnytimeKnobs(
            exit_thr=self._tensor(exit_thr).reshape(U),
            use_exit_thr=self._tensor(use_exit_thr).reshape(U),
            eta=self._tensor(np.float32(eta)),
            e_opt=self._tensor(np.float32(e_opt_fraction
                                          * self.scfg.capacity)),
        )

    def pack(self, requests: Sequence[AnytimeRequest]) -> AnytimeTables:
        """Pad/clip host requests into device tables."""
        sc = self.scfg
        N, P = len(requests), sc.prompt_len
        prompt = np.zeros((N, P), np.int32)
        plen = np.zeros((N,), np.int32)
        ntok = np.zeros((N,), np.int32)
        rel = np.zeros((N,), np.float32)
        ddl = np.zeros((N,), np.float32)
        for i, r in enumerate(requests):
            toks = np.asarray(list(r.prompt)[-P:], np.int32)
            if toks.size < 1:
                raise ValueError("empty prompt")
            prompt[i, :toks.size] = toks
            plen[i] = toks.size
            ntok[i] = min(max(int(r.n_tokens), 1), sc.max_new_tokens)
            rel[i] = r.release
            ddl[i] = r.deadline
        dev = self.device
        return AnytimeTables(
            prompt=torch.from_numpy(prompt).to(dev),
            prompt_len=torch.from_numpy(plen).to(dev),
            n_tokens=torch.from_numpy(ntok).to(dev),
            release=torch.from_numpy(rel).to(dev),
            deadline=torch.from_numpy(ddl).to(dev))

    def init_carry(self, tables: AnytimeTables, *,
                   telemetry: Optional[TEL.TelemetryConfig] = None
                   ) -> AnytimeCarry:
        N = tables.prompt.shape[0]
        B = self.scfg.batch_slots
        dev = self.device

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return AnytimeCarry(
            now=z((), _F32),
            energy=torch.tensor(_f32(self.scfg.start_frac
                                     * self.scfg.capacity),
                                dtype=_F32, device=dev),
            state=_map_state(torch.clone, self._zero_state),
            slot_req=torch.full((B,), -1, dtype=_I32, device=dev),
            slot_next=z((B,), _I32),
            req_status=z((N,), _I32), req_finish=z((N,), _F32),
            req_agree=z((N,), _I32), req_tokens=z((N,), _I32),
            req_depth=z((N,), _I32),
            tel=(None if telemetry is None else TEL.init_telemetry(
                telemetry, self.n_units, device=dev)))

    # ------------------------------------------------------------------ #
    def _admission_scores(self, tables, now, energy, knobs):
        """The admission priority of every request (larger first), in the
        reference's compiled arithmetic (see the module docstring)."""
        sc = self.scfg
        laxity = tables.deadline - now
        if sc.policy == "anytime":
            # zeta_I(laxity, utility 0, mandatory 1): base + gamma folds to
            # 3 - alpha * laxity, base alone to 2 - alpha * laxity
            m = laxity * _f32(sc.alpha)
            gate = knobs.eta * energy >= knobs.e_opt
            return torch.where(gate, 3.0 - m, 2.0 - m)
        return -(laxity + tables.release * _f32(POL._TIE))

    def _step(self, tables: AnytimeTables, carry: AnytimeCarry,
              knobs: AnytimeKnobs, tel_on: bool = False,
              zero_state=None) -> AnytimeCarry:
        cfg, sc = self.cfg, self.scfg
        B, U, m = sc.batch_slots, self.n_units, self.mandatory
        N = tables.prompt.shape[0]
        dev = self.device
        now, energy = carry.now, carry.energy
        slot_req, slot_next = carry.slot_req, carry.slot_next
        req_status = carry.req_status

        # --- admission: released, waiting requests into free slots ----- #
        scores = self._admission_scores(tables, now, energy, knobs)
        waiting = (req_status == 0) & (tables.release <= now)
        scores = torch.where(waiting, scores, POL.NEG)
        prev_slot_req = slot_req
        req_ids = torch.arange(N, device=dev)
        for b in range(B):
            best = torch.argmax(scores).to(_I32)
            ok = (slot_req[b] < 0) & (scores[best] > 0.5 * POL.NEG)
            slot_req = slot_req.clone()
            slot_req[b] = torch.where(ok, best, slot_req[b])
            scores = torch.where(ok & (req_ids == best), POL.NEG, scores)
        admitted = slot_req != prev_slot_req                     # (B,)
        req = torch.clamp(slot_req, 0, N - 1).long()
        req_status = _set_at(req_status, torch.where(admitted, req, N), 1)
        state = _map_state(
            lambda a, z: _where_rows(admitted, z, a), carry.state,
            self._zero_state if zero_state is None else zero_state)
        slot_next = torch.where(admitted, tables.prompt[req, 0], slot_next)

        # --- power: brownout when the store can't cover the base cost -- #
        active = slot_req >= 0
        on = energy >= _f32(sc.e_base)
        pos_leaf = state["pos"]
        pos = whole_of(pos_leaf).to(dev)            # placed over a mesh
        run_logits, run_state = A.unit_decode_step(
            cfg, self.params, self.heads, dict(state, pos=pos), slot_next,
            window=sc.window)
        if pos_leaf is not pos:
            run_state["pos"] = place_like(pos_leaf, run_state["pos"])
        unit_logits = torch.where(on, run_logits,
                                  torch.zeros((), dtype=_F32, device=dev))
        new_state = _map_state(lambda r, s: _where_rows(on, r, s),
                               run_state, state)
        run_mask = active & on

        # --- depth control --------------------------------------------- #
        plen = tables.prompt_len[req]
        ntok = tables.n_tokens[req]
        ddl = tables.deadline[req]
        gen_step = pos >= plen - 1        # this step's output is generated
        if sc.policy == "edf":
            depth = torch.full((B,), U, dtype=_I32, device=dev)
        elif sc.policy == "edf-m":
            depth = torch.full((B,), m, dtype=_I32, device=dev)
        else:
            marg = A.margins(unit_logits)                        # (U, B)
            depth, _ = A.select_depth(marg, knobs.exit_thr,
                                      knobs.use_exit_thr, m)
            if sc.deadline_cap:
                # greedy per-token latency budget for the remaining work
                rem = torch.clamp(
                    ntok - torch.clamp(pos - plen + 1, min=0), min=1)
                budget = (ddl - now) / rem.to(_F32)
                d_cap = torch.floor((budget - _f32(sc.t_base))
                                    * _recip(sc.unit_time)).to(_I32)
                depth = torch.minimum(depth, d_cap)
            gate_open = knobs.eta * energy >= knobs.e_opt
            depth = torch.where(gate_open, depth, m)
            depth = torch.clamp(depth, m, U)
        depth = torch.where(gen_step, depth, U)  # prompt steps: full depth
        depth = torch.where(run_mask, depth, 0).to(_I32)

        # --- continuous-batching cost ---------------------------------- #
        max_depth = depth.max().to(_F32)
        dt = fma_f32(_f32(sc.unit_time), max_depth, _f32(sc.t_base))
        base = run_mask.any().to(_F32) * _f32(sc.e_base)
        spent = depth.sum().to(_F32)
        if sc.policy == "anytime":
            consume = fma_f32(spent, _f32(sc.unit_energy), base)
        else:
            consume = spent * _f32(sc.unit_energy) + base
        slot_i = torch.clamp((now * _recip(sc.trace_dt)).to(_I32), 0,
                             self.trace.shape[0] - 1)
        new_energy = torch.clamp(
            fma_f32(dt, self.trace[slot_i.long()], energy - consume),
            0.0, _f32(sc.capacity))
        new_now = now + dt

        # --- emission + retirement ------------------------------------- #
        emit_full = torch.argmax(unit_logits[-1], -1).to(_I32)
        picked = A.take_at_depth(unit_logits, torch.clamp(depth, min=1))
        emit = torch.argmax(picked, -1).to(_I32)
        next_pos = pos + 1
        nxt = torch.where(
            next_pos < plen,
            tables.prompt[req, torch.clamp(next_pos, 0,
                                           sc.prompt_len - 1).long()],
            emit)
        slot_next = torch.where(run_mask, nxt, slot_next)
        gen_now = run_mask & gen_step
        emitted_after = torch.clamp(pos - plen + 2, min=0)
        agree_now = gen_now & (emit == emit_full)
        gen_req = torch.where(gen_now, req, N)
        req_agree = _add_at(carry.req_agree, gen_req, agree_now)
        req_tokens = _add_at(carry.req_tokens, gen_req,
                             torch.ones_like(gen_req))
        req_depth = _add_at(carry.req_depth, gen_req, depth)

        done = gen_now & (emitted_after >= ntok)
        ontime = done & (new_now <= ddl)
        done_req = torch.where(done, req, N)
        req_status = _set_at(
            req_status, done_req,
            torch.where(ontime, 2, 3).to(_I32))
        req_finish = _set_at(carry.req_finish, done_req,
                             new_now.expand(B))
        slot_req = torch.where(done, -1, slot_req).to(_I32)

        tel = carry.tel
        if tel_on:
            bins = torch.where(depth < U, depth - 1, U)
            depth_hist = (gen_now[:, None] & (bins[:, None] == torch.arange(
                U + 1, device=dev))).sum(0, dtype=_I32)
            slack = ddl - new_now
            zero = torch.zeros((), dtype=_F32, device=dev)
            inf = torch.full((), float("inf"), dtype=_F32, device=dev)
            tel = TEL.record_anytime_step(
                tel,
                releases=admitted.sum(dtype=_I32),
                misses=(done & ~ontime).sum(dtype=_I32),
                scheduled=ontime.sum(dtype=_I32),
                retired=done.sum(dtype=_I32),
                slack_sum=torch.where(done, slack, zero).sum(),
                slack_min=torch.where(done, slack, inf).amin(),
                depth_hist=depth_hist,
                occupancy=active.sum(dtype=_I32),
                energy=new_energy, t=new_now)

        return AnytimeCarry(
            now=new_now, energy=new_energy, state=new_state,
            slot_req=slot_req, slot_next=slot_next.to(_I32),
            req_status=req_status, req_finish=req_finish,
            req_agree=req_agree, req_tokens=req_tokens,
            req_depth=req_depth, tel=tel)

    # ------------------------------------------------------------------ #
    def run(self, requests, *, knobs: Optional[AnytimeKnobs] = None,
            telemetry=None, n_segments: int = 1, hook=None,
            mesh=None) -> AnytimeResult:
        """Serve ``requests`` (host :class:`AnytimeRequest` list or packed
        :class:`AnytimeTables`) over ``max_steps`` steps.

        ``n_segments`` splits the horizon into chunks (the same result for
        any split); ``hook(seg_index, carry, knobs)`` runs between segments
        and may return replacement :class:`AnytimeKnobs`.  ``telemetry``
        (a :class:`repro_torch.telemetry.TelemetryConfig`) fills
        ``AnytimeResult.telemetry``.  ``mesh`` (a
        :class:`repro_torch.launch.mesh.Mesh` with ``data`` and ``model``
        axes) places the decode state by
        :func:`repro_torch.launch.sharding.state_specs` and runs each
        step's model on the blocks (the carry a ``hook`` sees holds the
        placed state; :func:`repro_torch.launch.sharding.gather` makes it
        whole).  On a mesh of one device the state is the one block.
        """
        tables = (requests if isinstance(requests, AnytimeTables)
                  else self.pack(requests))
        knobs = knobs if knobs is not None else self.default_knobs()
        carry = self.init_carry(tables, telemetry=telemetry)
        zero = None
        if mesh is not None:
            from ..launch import sharding as SH

            shardings = SH.named(mesh, SH.state_specs(mesh, carry.state))
            state = SH.device_put(carry.state, shardings)
            if mesh.size == 1:
                state = SH.blocks(state)[0]
            else:
                zero = SH.device_put(self._zero_state, shardings)
            carry = carry._replace(state=state)
        T_total = self.scfg.max_steps
        if not 1 <= n_segments <= T_total:
            raise ValueError(f"n_segments {n_segments} outside "
                             f"[1, {T_total}]")
        base, extra = divmod(T_total, n_segments)
        tel_on = telemetry is not None
        for seg in range(n_segments):
            n_steps = base + (1 if seg < extra else 0)
            for _ in range(n_steps):
                carry = self._step(tables, carry, knobs, tel_on, zero)
            if hook is not None:
                new = hook(seg, carry, knobs)
                if new is not None:
                    knobs = new
        return self._finalize(tables, carry)

    def _finalize(self, tables: AnytimeTables,
                  carry: AnytimeCarry) -> AnytimeResult:
        status = carry.req_status.cpu().numpy()
        finish = carry.req_finish.cpu().numpy().astype(np.float64)
        deadline = tables.deadline.cpu().numpy().astype(np.float64)
        horizon = float(carry.now.cpu())
        finish = np.where(status >= 2, finish, horizon)
        tardiness = np.maximum(0.0, finish - deadline)
        return AnytimeResult(
            status=status, finish=finish, tardiness=tardiness,
            agree=carry.req_agree.cpu().numpy(),
            tokens=carry.req_tokens.cpu().numpy(),
            depth_sum=carry.req_depth.cpu().numpy(),
            requested=tables.n_tokens.cpu().numpy(),
            horizon=horizon, n_units=self.n_units, telemetry=carry.tel)

    # ------------------------------------------------------------------ #
    def score_fn(self, tables: AnytimeTables, *,
                 tardiness_weight: float = 0.0):
        """A ``knobs -> scalar score`` function (the :mod:`repro_torch
        .adapt` objective surface): the on-time agreed-token fraction minus
        ``tardiness_weight`` x mean tardiness over the mean deadline.  Each
        call runs the engine once."""
        T_total = self.scfg.max_steps
        norm = torch.clamp(tables.deadline.mean(), min=1e-6)

        def score(knobs: AnytimeKnobs) -> torch.Tensor:
            carry = self.init_carry(tables)
            for _ in range(T_total):
                carry = self._step(tables, carry, knobs)
            ontime = carry.req_status == 2
            good = torch.where(ontime, carry.req_agree, 0).sum()
            frac = good.to(_F32) / torch.clamp(
                tables.n_tokens.sum(), min=1).to(_F32)
            finish = torch.where(carry.req_status >= 2, carry.req_finish,
                                 carry.now)
            tardy = torch.clamp(finish - tables.deadline, min=0.0).mean()
            return frac - tardiness_weight * tardy / norm

        return score
