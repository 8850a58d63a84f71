"""Mixture-of-Experts FFN with grouped, capacity-based token dispatch (port
of :mod:`repro.models.moe`).

Tokens are processed in groups of ``cfg.moe_group_size`` (halved until it
divides the token count); within each group a top-k router assigns tokens
to experts with a fixed per-expert capacity ``C`` (``capacity_factor``).
A (token, slot) pair's place in its expert's buffer is a running count over
the group's pairs, token-major and slot-minor; pairs past ``C`` are
dropped.  Dispatch, the expert products and the combine are einsums, as in
the reference (which leaves them to XLA, outside any Pallas kernel).

The router runs in f32 on the f32 activations.  ``jax.lax.top_k`` puts the
lower expert index first on a tie; the port takes a stable descending sort
(:func:`top_k`), which does the same.  The dispatch and combine tensors
are built in f32 and cast to the activation dtype before their einsums.
Each token's experts are distinct, so every entry of them has at most one
non-zero term: dispatch copies a token exactly and combine scales it by its
renormalised gate.

The load-balance auxiliary loss is Switch Transformer's (mean gate prob x
mean dispatch fraction per expert), in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import activate, dense_init, scaled_normal

_F32 = torch.float32


def init_moe(g, cfg, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(g, d, (e,), _F32),
         "w1": scaled_normal(g, (e, d, f), d ** -0.5, dtype),
         "w2": scaled_normal(g, (e, f, d), f ** -0.5, dtype)}
    if cfg.act == "swiglu":
        p["w3"] = scaled_normal(g, (e, d, f), d ** -0.5, dtype)
    return p


def _capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(group * top_k * factor / n_experts)
    return max(4, c)


def group_size(cfg, n_tokens: int) -> int:
    """Tokens per dispatch group: ``moe_group_size`` cut to the token count
    and halved until it divides it."""
    G = min(cfg.moe_group_size, n_tokens)
    while n_tokens % G:
        G //= 2
    return G


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One call's routing, per group ``g`` of ``t`` tokens: the router's
    softmax ``probs`` (g, t, E), the chosen experts ``expert_idx`` (g, t,
    K), their renormalised gates ``gate`` (g, t, K), the one-hot
    ``assign`` (g, t, K, E), ``keep`` (``assign`` without the dropped
    pairs) and each pair's buffer position ``pos`` (g, t, K, E), clipped to
    ``[0, C - 1]``; ``capacity`` is ``C``."""

    probs: torch.Tensor
    expert_idx: torch.Tensor
    gate: torch.Tensor
    assign: torch.Tensor
    keep: torch.Tensor
    pos: torch.Tensor
    capacity: int


def route(p: dict, cfg, xg: torch.Tensor) -> Routing:
    """The router over grouped tokens ``xg`` (g, t, D)."""
    n_groups, G, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(G, K, E, cfg.capacity_factor)
    logits = torch.einsum("gtd,de->gte", xg.to(_F32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = top_k(probs, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    assign = F.one_hot(expert_idx, E).to(_F32)                  # (g,t,K,E)
    # position of each (token, slot) within its expert's capacity buffer
    pos = torch.cumsum(assign.reshape(n_groups, G * K, E), dim=1).reshape(
        n_groups, G, K, E) - assign
    keep = (pos < C).to(_F32) * assign                  # drop overflow pairs
    pos = torch.clamp(pos, 0, C - 1).to(torch.int64)
    return Routing(probs, expert_idx, gate, assign, keep, pos, C)


def apply_moe(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D), aux_loss f32 scalar)."""
    B, S, D = x.shape
    E = cfg.n_experts
    G = group_size(cfg, B * S)
    xg = x.reshape((B * S) // G, G, D)
    r = route(p, cfg, xg)

    # dispatch/combine tensors (g, t, E, C), built in f32
    slot_onehot = F.one_hot(r.pos, r.capacity).to(_F32)     # (g,t,K,E,C)
    disp = torch.einsum("gtke,gtkec->gtec", r.keep, slot_onehot).to(x.dtype)
    combine = torch.einsum("gtk,gtke,gtkec->gtec", r.gate, r.keep,
                           slot_onehot).to(x.dtype)
    del slot_onehot

    xe = torch.einsum("gtec,gtd->gecd", disp, xg)
    h = torch.einsum("gecd,edf->gecf", xe, p["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.einsum("gecd,edf->gecf", xe, p["w3"])
    else:
        h = activate(cfg.act, h)
    ye = torch.einsum("gecf,efd->gecd", h, p["w2"])
    out = torch.einsum("gtec,gecd->gtd", combine, ye)

    # Switch-style load-balance loss
    frac_tokens = torch.mean(r.assign.sum(2), dim=1)      # (g, E) routed
    frac_probs = torch.mean(r.probs, dim=1)               # (g, E)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return out.reshape(B, S, D), aux.to(_F32)
