"""Anytime (imprecise) execution of the model configs (port of
:mod:`repro.models.anytime`).

The layer stack is grouped into ``cfg.n_units`` schedulable units of
``cfg.exit_every`` layers, the first ``cfg.resolved_mandatory_units`` of
them mandatory.  Each non-final unit gets a lightweight exit head: the
model's own ``final_norm`` + LM head, modulated by a per-unit diagonal gain
(ones at init).  The **final** unit bypasses the gain and reads the stock
readout, so full-depth anytime output is bit-exact against
:func:`repro_torch.models.transformer.forward` /
:func:`~repro_torch.models.transformer.decode_step` — the port runs the
same operations on the same shapes in both, and
``tests/test_torch_anytime.py`` holds that contract.  The exit decision is
the margin utility test of the agile path: exit at the first enabled unit
whose top1 - top2 logit margin clears its threshold (:func:`select_depth`),
thresholds calibrated against a target agreement with full depth
(:func:`calibrate_thresholds`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import policy
from . import transformer as T
from .common import apply_norm, dtype_of

__all__ = [
    "init_heads", "exit_readout", "anytime_forward", "unit_decode_step",
    "margins", "select_depth", "take_at_depth", "calibrate_thresholds",
    "unit_boundaries",
]

_F32 = torch.float32
_I32 = torch.int32


def unit_boundaries(cfg) -> Tuple[int, ...]:
    """Absolute layer count after which each unit ends (last entry =
    ``cfg.n_layers``)."""
    return tuple(min(cfg.n_layers, (u + 1) * cfg.exit_every)
                 for u in range(cfg.n_units))


def init_heads(cfg, device="cuda") -> dict:
    """Per-unit exit-head parameters: a diagonal gain on the normed hidden
    state (ones: a fresh head reads the stock LM head early)."""
    return {"gain": torch.ones((cfg.n_units, cfg.d_model),
                               dtype=dtype_of(cfg), device=device)}


def exit_readout(cfg, params, heads, x: torch.Tensor,
                 unit: int) -> torch.Tensor:
    """Exit-head logits for ``unit`` from hidden state ``x`` (``(B, D)`` or
    ``(B, S, D)``): f32 with a trailing vocab axis.  The final unit is the
    stock readout chain; earlier units scale the normed state by their
    gain first."""
    h = apply_norm(cfg.norm, params["final_norm"], x)
    if unit < cfg.n_units - 1:
        h = h * heads["gain"][unit].to(h.dtype)
    head = T._head(cfg, params)
    if x.dim() == 2:
        return torch.einsum("bd,dv->bv", h, head).to(_F32)
    return torch.einsum("bsd,dv->bsv", h, head).to(_F32)


def anytime_forward(cfg, params, heads, batch: dict, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Sequence-path anytime forward: ``(U, B, S, V)`` per-unit logits; row
    ``U-1`` equals ``forward(...)[0]`` bit for bit.  ``batch`` may carry a
    ``"frontend"`` (an encoder-decoder's frames, encoded once and read by
    every unit's cross-attention; a VLM's patches, prepended)."""
    x, enc_out = T.embed_inputs(cfg, params, batch)
    outs = []
    for u in range(cfg.n_units):
        x, _ = T.unit_forward(cfg, params, x, u, enc_out=enc_out,
                              window=window)
        outs.append(exit_readout(cfg, params, heads, x, u))
    return torch.stack(outs)


def unit_decode_step(cfg, params, heads, state: dict, token: torch.Tensor,
                     *, window: Optional[int] = None):
    """One anytime serving step: ``token (B,) int32 -> ((U, B, V) f32
    per-unit logits, new state)``.

    Runs every layer in order as :func:`~repro_torch.models.transformer
    .decode_step` does and reads an exit head at each unit boundary; takes
    a ``stacked=False`` decode state (an encoder-decoder's carries its
    ``enc_out`` and cross keys and values through).  The final unit's row equals
    ``decode_step``'s logits bit for bit.  The full stack always runs:
    depth is charged by the scheduler (:mod:`repro_torch.serve.anytime`).
    """
    bounds = unit_boundaries(cfg)
    x = T._embed(cfg, params, token)
    pos = state["pos"]
    new_layers, unit_logits, unit = [], [], 0
    for i in range(cfg.n_layers):
        kind, bp = T.get_block(cfg, params, i)
        x, ns = T.block_step(bp, cfg, kind, x, T._layer_state(cfg, state, i),
                             pos, window=window)
        new_layers.append(ns)
        if i + 1 == bounds[unit]:
            unit_logits.append(exit_readout(cfg, params, heads, x, unit))
            unit += 1
    new_state = T._assemble_state(cfg, state, pos + 1, new_layers,
                                  stacked=False)
    return torch.stack(unit_logits), new_state


def margins(unit_logits: torch.Tensor) -> torch.Tensor:
    """Top1 - top2 logit margin per unit: ``(U, ..., V) -> (U, ...)``."""
    top2 = torch.topk(unit_logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def select_depth(margin: torch.Tensor, exit_thr, use_exit_thr,
                 mandatory=1):
    """Depth selected by the utility test.

    margin       : (U, ...) per-unit margins
    exit_thr     : (U,) per-unit thresholds
    use_exit_thr : (U,) bool/0-1 per-unit enables
    mandatory    : scalar; units before this index may not exit

    Returns ``(depth, exit_unit)``: ``depth`` in ``[1, U]`` (the first
    enabled unit ``u >= mandatory - 1`` whose margin clears its threshold,
    else full depth) and ``exit_unit`` in ``[0, U]`` (U = never exited),
    both int32 with the trailing shape of ``margin``.
    """
    U = margin.shape[0]
    dev = margin.device
    extra = (1,) * (margin.dim() - 1)
    u = torch.arange(U, device=dev).reshape((U,) + extra)
    can = (u >= mandatory - 1) & (u < U - 1)
    enabled = torch.as_tensor(use_exit_thr, device=dev).to(
        torch.bool).reshape((U,) + extra)
    thr = torch.as_tensor(exit_thr, device=dev).to(_F32).reshape(
        (U,) + extra)
    fire = can & enabled & policy.exit_test(margin, thr)
    first = torch.argmax(fire.to(torch.uint8), dim=0).to(_I32)
    any_fire = fire.any(dim=0)
    depth = torch.where(any_fire, first + 1, U).to(_I32)
    exit_unit = torch.where(any_fire, first, U).to(_I32)
    return depth, exit_unit


def take_at_depth(values: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Select the per-unit value at each element's depth: ``values`` (U,
    ...) with optional trailing axes, ``depth`` (...) in [1, U] ->
    ``values[depth - 1]`` elementwise."""
    idx = depth.to(torch.int64) - 1
    while idx.dim() < values.dim() - 1:
        idx = idx[..., None]
    idx = idx.expand(values.shape[1:])
    return torch.gather(values, 0, idx[None])[0]


def calibrate_thresholds(unit_logits, *, target_agreement: float = 0.98):
    """Host-side threshold calibration against full-depth agreement.

    For each non-final unit, finds the smallest margin threshold such that
    among calibration tokens with ``margin > threshold`` the exit
    prediction agrees with the full-depth prediction at rate >=
    ``target_agreement``; units that cannot reach the target stay
    disabled.  Returns ``(exit_thr (U,) f32, use_exit_thr (U,) bool)``
    tensors on ``unit_logits``' device.
    """
    if not isinstance(unit_logits, torch.Tensor):
        unit_logits = torch.from_numpy(np.asarray(unit_logits, np.float32))
    lt = unit_logits.detach().to(_F32)
    U, V = lt.shape[0], lt.shape[-1]
    flat = lt.reshape(U, -1, V)
    # the argmax and the top-two margin on the tensor's device; the margin
    # is the same f32 difference the reference takes of its partition
    top2 = torch.topk(flat, 2, dim=-1).values
    preds = flat.argmax(-1).cpu().numpy()
    marg = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    final = preds[-1]
    thr = np.full((U,), np.inf, np.float32)
    use = np.zeros((U,), bool)
    for u in range(U - 1):
        agree = (preds[u] == final).astype(np.float64)
        order = np.argsort(-marg[u], kind="stable")
        cum = np.cumsum(agree[order]) / np.arange(1, order.size + 1)
        ok = np.nonzero(cum >= target_agreement)[0]
        if not ok.size:
            continue
        k = int(ok.max())         # largest high-margin prefix meeting target
        m_in = marg[u][order[k]]  # smallest included margin
        if k + 1 < order.size:
            thr[u] = 0.5 * (m_in + marg[u][order[k + 1]])
        else:
            thr[u] = m_in - 1.0   # everything qualifies
        if thr[u] >= m_in:        # ties: keep the strict > test inclusive
            thr[u] = np.nextafter(m_in, -np.inf)
        use[u] = True
    return (torch.from_numpy(thr).to(lt.device),
            torch.from_numpy(use).to(lt.device))
