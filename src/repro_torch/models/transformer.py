"""Model assembly for the dense attention family and the RG-LRU hybrid
(port of :mod:`repro.models.transformer`).

Parameters keep the reference's stacked layout, so a converted JAX pytree
drops straight in (:func:`repro_torch.convert.transformer_params`):
``params["layers"]["stack"]`` is a tuple over the block pattern's period
of dicts whose leaves carry a leading ``(n_scan, ...)`` layer axis, and
``params["layers"]["rem"]`` holds the remainder blocks.  The reference
scans over that axis under ``jit``; the port loops over it eagerly.

The port runs the ``"attn"`` block kind with a dense FFN (the ``dense``
family: qwen1.5-0.5b, glm4-9b, minitron-8b, stablelm-3b) and the ``"rec"``
block kind (conv1d + RG-LRU, :mod:`repro_torch.models.rglru`; the hybrid
recurrentgemma-9b).  The xLSTM block kinds, the MoE FFN, the
encoder-decoder's cross-attention and the VLM's frontend tokens raise
``NotImplementedError`` naming the ROADMAP item that ports them.
``remat`` / ``remat_attention`` are training knobs: accepted and ignored
in the forward pass.  JAX's arrays are immutable; the port's
functions return new state dicts too (a KV-cache write copies the cache of
that layer), so a caller's state is never changed in place.

Public entry points:
    init_params / forward / prefill / decode_step / init_decode_state
    unit_forward (Zygarde agile execution: one unit = ``exit_every`` blocks)
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from . import rglru as rg
from .attention import chunked_attention, decode_attention
from .common import (
    apply_norm,
    apply_rope,
    activate,
    dense_init,
    dtype_of,
    embed_init,
    norm_init,
    scaled_normal,
    zeros,
)

_F32 = torch.float32
_I32 = torch.int32

#: the block kinds the port runs
_KINDS = ("attn", "rec")
#: what each unported part of the model zoo waits for
_TODO = {
    "mlstm": "the xLSTM blocks (models/xlstm.py)",
    "slstm": "the xLSTM blocks (models/xlstm.py)",
    "moe": "the MoE FFN (models/moe.py)",
    "xattn": "the encoder-decoder (cross-attention and the encoder)",
    "frontend": "the VLM/audio frontend tokens",
}


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {_TODO[what]} "
        f"(ROADMAP Queue 1, the model-zoo item)")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is built of the block
    kinds ``"attn"`` and ``"rec"`` with no experts, no encoder and no
    frontend."""
    for kind in cfg.block_pattern:
        if kind not in _KINDS:
            raise _unported(kind)
    if cfg.n_experts:
        raise _unported("moe")
    if cfg.is_encoder_decoder:
        raise _unported("xattn")
    if cfg.n_frontend_tokens:
        raise _unported("frontend")


# --------------------------------------------------------------------------- #
# Block parameter initialisation.
# --------------------------------------------------------------------------- #


def _init_attn(g, cfg, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(g, d, (H, hd), dtype),
        "wk": dense_init(g, d, (KV, hd), dtype),
        "wv": dense_init(g, d, (KV, hd), dtype),
        "wo": scaled_normal(g, (H, hd, d), (H * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H, hd), dtype, g.device)
        p["bk"] = zeros((KV, hd), dtype, g.device)
        p["bv"] = zeros((KV, hd), dtype, g.device)
    return p


def _init_ffn(g, cfg, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(g, d, (f,), dtype),
         "w2": scaled_normal(g, (f, d), f ** -0.5, dtype)}
    if cfg.act == "swiglu":
        p["w3"] = dense_init(g, d, (f,), dtype)
    return p


def init_block(g, cfg, kind: str) -> dict:
    if kind not in _KINDS:
        raise _unported(kind)
    dtype = dtype_of(cfg)
    d = cfg.d_model
    p: dict = {"norm1": norm_init(cfg.norm, d, dtype, g.device)}
    if kind == "attn":
        p["attn"] = _init_attn(g, cfg, dtype)
    else:
        w = cfg.resolved_rglru_width
        p["gate_proj"] = dense_init(g, d, (w,), dtype)
        p["rec_proj"] = dense_init(g, d, (w,), dtype)
        p["conv"] = rg.init_conv1d(g, w, cfg.conv1d_width, dtype)
        p["rglru"] = rg.init_rglru(g, w, dtype, n_blocks=cfg.n_heads)
        p["out_proj"] = dense_init(g, w, (d,), dtype)
    p["norm2"] = norm_init(cfg.norm, d, dtype, g.device)
    if cfg.d_ff:
        p["ffn"] = _init_ffn(g, cfg, dtype)
    return p


# --------------------------------------------------------------------------- #
# Block application — full-sequence (train / prefill).
# --------------------------------------------------------------------------- #


def _qkv(p: dict, cfg, h: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dnh->bsnh", h, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", h, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", h, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def block_seq(p: dict, cfg, kind: str, x: torch.Tensor, *,
              enc_out: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None, collect_cache: bool = False,
              scanned: bool = False):
    """x: (B, S, D) -> (x, aux_loss, cache_kv or None).  ``scanned``: the
    reference runs this layer inside its compiled layer scan (see
    :mod:`repro_torch.models.rglru`)."""
    if kind not in _KINDS:
        raise _unported(kind)
    if "xattn" in p or enc_out is not None:
        raise _unported("xattn")
    if "moe" in p:
        raise _unported("moe")
    aux = torch.zeros((), dtype=_F32, device=x.device)
    if kind == "rec":
        x, _, _ = _rec_seq(p, cfg, x, scanned)
        return x, aux, None
    cache = None
    B, S, D = x.shape
    window = cfg.window if window is None else window
    h = apply_norm(cfg.norm, p["norm1"], x)
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p["attn"], cfg, h, positions)
    o = chunked_attention(q, k, v, causal=causal, window=window,
                          chunk=cfg.attn_chunk)
    x = x + torch.einsum("bsnh,nhd->bsd", o, p["attn"]["wo"])
    if collect_cache:
        cache = (k, v)
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    y = (_apply_ffn(p["ffn"], cfg, h2) if "ffn" in p
         else torch.zeros_like(x))
    return x + y, aux, cache


def _rec_seq(p: dict, cfg, x: torch.Tensor, scanned: bool = False):
    """The ``"rec"`` block over a sequence: (x, the RG-LRU's last state
    (B, W) f32, the conv's pre-conv input r (B, S, W))."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    gate = F.gelu(torch.einsum("bsd,dw->bsw", h, p["gate_proj"]),
                  approximate="tanh")
    r = torch.einsum("bsd,dw->bsw", h, p["rec_proj"])
    rc = rg.conv1d_seq(p["conv"], r)
    ry, h_last = rg.rglru_seq(p["rglru"], rc, scanned=scanned)
    x = x + torch.einsum("bsw,wd->bsd", gate * ry, p["out_proj"])
    if cfg.d_ff:
        h2 = apply_norm(cfg.norm, p["norm2"], x)
        x = x + _apply_ffn(p["ffn"], cfg, h2)
    return x, h_last, r


def _apply_ffn(p: dict, cfg, h: torch.Tensor) -> torch.Tensor:
    u = torch.einsum("bsd,df->bsf", h, p["w1"])
    if cfg.act == "swiglu":
        u = F.silu(u) * torch.einsum("bsd,df->bsf", h, p["w3"])
    else:
        u = activate(cfg.act, u)
    return torch.einsum("bsf,fd->bsd", u, p["w2"])


# --------------------------------------------------------------------------- #
# Block application — single-token decode.
# --------------------------------------------------------------------------- #


def _slot_positions(pos: torch.Tensor, capacity: int) -> torch.Tensor:
    """Absolute position stored in each ring-buffer slot (-1 = empty).

    pos: (B,) number of tokens already written.  Slot s holds the largest
    p < pos with p % capacity == s.
    """
    s = torch.arange(capacity, device=pos.device)
    last = pos[:, None] - 1
    cand = last - torch.remainder(last - s[None, :], capacity)
    return torch.where((cand >= 0) & (pos[:, None] > 0), cand,
                       torch.full_like(cand, -1))


def _write_slot(cache: torch.Tensor, val: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """cache: (B, C, ...), val: (B, ...), slot: (B,) per-batch write index;
    returns a new cache."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device),
        slot.long()] = val.to(cache.dtype)
    return out


def block_step(p: dict, cfg, kind: str, x: torch.Tensor, state: dict,
               pos: torch.Tensor, *, window: Optional[int] = None,
               scanned: bool = False):
    """x: (B, D); state: per-block decode state; pos: (B,) current
    position; ``scanned`` as in :func:`block_seq`."""
    if kind not in _KINDS:
        raise _unported(kind)
    if "xattn" in p:
        raise _unported("xattn")
    if "moe" in p:
        raise _unported("moe")
    window = cfg.window if window is None else window
    new_state = dict(state)
    if kind == "rec":
        h = apply_norm(cfg.norm, p["norm1"], x)
        gate = F.gelu(torch.einsum("bd,dw->bw", h, p["gate_proj"]),
                      approximate="tanh")
        r = torch.einsum("bd,dw->bw", h, p["rec_proj"])
        r, new_state["buf"] = rg.conv1d_step(p["conv"], r, state["buf"])
        r, new_state["h"] = rg.rglru_step(p["rglru"], r, state["h"],
                                          scanned=scanned)
        x = x + torch.einsum("bw,wd->bd", gate * r, p["out_proj"])
        if cfg.d_ff:
            h2 = apply_norm(cfg.norm, p["norm2"], x)
            x = x + _apply_ffn(p["ffn"], cfg, h2[:, None])[:, 0]
        return x, new_state
    h = apply_norm(cfg.norm, p["norm1"], x)[:, None]            # (B, 1, D)
    q, k, v = _qkv(p["attn"], cfg, h, pos[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    C = state["k"].shape[1]
    slot = torch.remainder(pos, C)
    k_cache = _write_slot(state["k"], k, slot)
    v_cache = _write_slot(state["v"], v, slot)
    slot_pos = _slot_positions(pos + 1, C)
    o = decode_attention(q, k_cache, v_cache, slot_pos, pos, window)
    x = x + torch.einsum("bnh,nhd->bd", o, p["attn"]["wo"])
    new_state["k"], new_state["v"] = k_cache, v_cache
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    y = (_apply_ffn(p["ffn"], cfg, h2[:, None])[:, 0] if "ffn" in p
         else torch.zeros_like(x))
    return x + y, new_state


# --------------------------------------------------------------------------- #
# Whole-model parameters.
# --------------------------------------------------------------------------- #


def _layer_plan(cfg) -> Tuple[int, int, list]:
    period = cfg.pattern_period
    n_scan = cfg.n_layers // period
    rem_kinds = [cfg.layer_kind(n_scan * period + i)
                 for i in range(cfg.n_layers - n_scan * period)]
    return period, n_scan, rem_kinds


def _stack_dicts(blocks: list) -> dict:
    first = blocks[0]
    return {k: (_stack_dicts([b[k] for b in blocks]) if isinstance(v, dict)
                else torch.stack([b[k] for b in blocks]))
            for k, v in first.items()}


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def init_params(cfg, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda") -> dict:
    """Random parameters in the reference's layout and distributions, drawn
    from ``generator`` (default: a fresh one on ``device`` seeded with
    ``seed``); the parameters live on the generator's device."""
    check_supported(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    g = generator
    dtype = dtype_of(cfg)
    period, n_scan, rem_kinds = _layer_plan(cfg)
    stack = tuple(
        _stack_dicts([init_block(g, cfg, cfg.layer_kind(q))
                      for _ in range(n_scan)])
        for q in range(period))
    rem = tuple(init_block(g, cfg, kind) for kind in rem_kinds)
    params = {
        "embed": embed_init(g, cfg.padded_vocab, cfg.d_model, dtype),
        "layers": {"stack": stack, "rem": rem},
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, g.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, cfg.d_model, (cfg.padded_vocab,),
                                       dtype)
    return params


# --------------------------------------------------------------------------- #
# Full-sequence forward (prefill).
# --------------------------------------------------------------------------- #


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _check_batch(cfg, batch: dict) -> None:
    check_supported(cfg)
    if "frontend" in batch:
        raise _unported("frontend")


def _blocks(cfg, params):
    """(kind, block params) for every layer in order."""
    for i in range(cfg.n_layers):
        yield get_block(cfg, params, i)


def _head(cfg, params) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _readout(cfg, params, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return torch.einsum("bsd,dv->bsv", x, _head(cfg, params)).to(_F32)


def forward(cfg, params, batch: dict, *, window: Optional[int] = None,
            remat: bool = True):
    """batch: {"tokens": (B, S) int32}.  Returns (logits (B, S, V) f32,
    aux_loss scalar).  ``remat`` only says which layers the reference
    scans: its groups of ``remat_every`` periods (every period without
    ``remat``); the leftover periods and the remainder run op by op."""
    _check_batch(cfg, batch)
    period, n_scan, _ = _layer_plan(cfg)
    k = max(1, cfg.remat_every) if remat else 1
    n_scanned = (n_scan // k) * k * period
    x = _embed(cfg, params, batch["tokens"])
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for i, (kind, bp) in enumerate(_blocks(cfg, params)):
        x, a, _ = block_seq(bp, cfg, kind, x, window=window,
                            scanned=i < n_scanned)
        aux = aux + a
    return _readout(cfg, params, x), aux


# --------------------------------------------------------------------------- #
# Decode state and serving steps.
# --------------------------------------------------------------------------- #


def _block_state(cfg, kind: str, batch: int, cache_len: int,
                 device) -> dict:
    if kind not in _KINDS:
        raise _unported(kind)
    dtype = dtype_of(cfg)
    if kind == "rec":
        w = cfg.resolved_rglru_width
        return {"h": torch.zeros((batch, w), dtype=_F32, device=device),
                "buf": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                   dtype=dtype, device=device)}
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"k": torch.zeros((batch, cache_len, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cache_len, KV, hd), dtype=dtype,
                             device=device)}


def cache_capacity(cfg, seq_len: int, window: Optional[int] = None) -> int:
    """Ring-buffer KV capacity: window+1 slots (rounded up to a 128
    multiple), capped at the sequence length.  Any capacity >= window+1 is
    correct: extra slots hold older positions the window mask excludes."""
    w = cfg.window if window is None else window
    if not w:
        return seq_len
    cap = -(-(w + 1) // 128) * 128
    return min(seq_len, cap)


def init_decode_state(cfg, batch: int, seq_len: int, *,
                      window: Optional[int] = None,
                      cache_len: Optional[int] = None, stacked: bool = True,
                      device="cuda") -> dict:
    """Decode state.  ``stacked=True`` holds per-period ``(n_scan, ...)``
    tensors (the reference's scanned layout); ``stacked=False`` one buffer
    per layer (the layout of the unrolled decode and the anytime engine)."""
    check_supported(cfg)
    period, n_scan, rem_kinds = _layer_plan(cfg)
    cache_len = cache_len or cache_capacity(cfg, seq_len, window)

    def stacked_state(kind):
        one = _block_state(cfg, kind, batch, cache_len, device)
        return {k: v.expand(n_scan, *v.shape).clone()
                for k, v in one.items()}

    def unstacked_state(kind):
        return tuple(_block_state(cfg, kind, batch, cache_len, device)
                     for _ in range(n_scan))

    make = stacked_state if stacked else unstacked_state
    return {
        "pos": torch.zeros((batch,), dtype=_I32, device=device),
        "stack": tuple(make(cfg.layer_kind(q)) for q in range(period)),
        "rem": tuple(_block_state(cfg, kind, batch, cache_len, device)
                     for kind in rem_kinds),
    }


def _layer_state(cfg, state, i: int) -> dict:
    period, n_scan, _ = _layer_plan(cfg)
    if i >= n_scan * period:
        return state["rem"][i - n_scan * period]
    q, r = i % period, i // period
    st = state["stack"][q]
    return _index(st, r) if isinstance(st, dict) else st[r]


def _assemble_state(cfg, pos: torch.Tensor, new_layers: list,
                    stacked: bool) -> dict:
    """A decode state from one block state per layer, stacked per period
    (``stacked``) or one buffer per layer."""
    period, n_scan, _ = _layer_plan(cfg)
    per_q = [[new_layers[r * period + q] for r in range(n_scan)]
             for q in range(period)]
    stack = tuple(_stack_dicts(states) if stacked else tuple(states)
                  for states in per_q)
    return {"pos": pos, "stack": stack,
            "rem": tuple(new_layers[n_scan * period:])}


def decode_step(cfg, params, state: dict, token: torch.Tensor, *,
                window: Optional[int] = None, unroll: bool = False):
    """One serving step: token (B,) int32 -> (logits (B, V) f32, new
    state).  Takes both state layouts; ``unroll`` is accepted for the
    reference's signature (the port always runs the layers in order).  A
    stacked state is the reference's scanned decode: its periods run as
    ``scanned`` layers; an unstacked one its unrolled, op-by-op decode."""
    del unroll
    check_supported(cfg)
    period, n_scan, _ = _layer_plan(cfg)
    stacked = bool(state["stack"]) and isinstance(state["stack"][0], dict)
    n_scanned = n_scan * period if stacked else 0
    x = _embed(cfg, params, token)
    pos = state["pos"]
    new_layers = []
    for i, (kind, bp) in enumerate(_blocks(cfg, params)):
        x, ns = block_step(bp, cfg, kind, x, _layer_state(cfg, state, i),
                           pos, window=window, scanned=i < n_scanned)
        new_layers.append(ns)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = torch.einsum("bd,dv->bv", x, _head(cfg, params)).to(_F32)
    return logits, _assemble_state(cfg, pos + 1, new_layers, stacked)


def prefill(cfg, params, batch: dict, *, window: Optional[int] = None,
            cache_len: Optional[int] = None):
    """Run the full prompt, returning last-position logits + a (stacked)
    decode state whose KV caches hold the last ``cache_len`` positions and
    whose recurrent blocks hold the RG-LRU's last state and the conv's last
    ``k - 1`` inputs.  For full-attention serving pass ``cache_len >=
    prompt + max_new_tokens``."""
    _check_batch(cfg, batch)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or cache_capacity(cfg, S, window)
    period, n_scan, _ = _layer_plan(cfg)
    x = _embed(cfg, params, tokens)
    new_layers = []
    for i, (kind, bp) in enumerate(_blocks(cfg, params)):
        if kind == "rec":
            # the reference scans its periods; the remainder runs op by op
            x, h_last, r = _rec_seq(bp, cfg, x, i < n_scan * period)
            new_layers.append({"h": h_last, "buf": _conv_tail(
                r, bp["conv"]["w"].shape[0])})
            continue
        x, _, (k, v) = block_seq(bp, cfg, kind, x, window=window,
                                 collect_cache=True)
        new_layers.append({"k": _ring_fill(k, cache_len),
                           "v": _ring_fill(v, cache_len)})
    pos = torch.full((B,), x.shape[1], dtype=_I32, device=x.device)
    logits = _readout(cfg, params, x[:, -1:])[:, 0]
    return logits, _assemble_state(cfg, pos, new_layers, stacked=True)


def _conv_tail(r: torch.Tensor, kw: int) -> torch.Tensor:
    """The conv's rolling buffer after a sequence: its last ``kw - 1``
    pre-conv inputs, zeros before the sequence's start as the causal conv
    pads (the reference takes ``r[:, -(kw - 1):]``, which a prompt shorter
    than ``kw - 1`` leaves short)."""
    return F.pad(r, (0, 0, kw - 1, 0))[:, r.shape[1]:]


def _ring_fill(kv: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Place the last ``cache_len`` sequence positions into ring order."""
    B, S = kv.shape[:2]
    tail = kv[:, -cache_len:]
    if S <= cache_len:
        pad = torch.zeros((B, cache_len - S, *kv.shape[2:]), dtype=kv.dtype,
                          device=kv.device)
        return torch.cat([tail, pad], dim=1)
    # absolute positions S-cache_len .. S-1 go to slot p % cache_len
    start = S - cache_len
    slots = torch.remainder(start + torch.arange(cache_len,
                                                 device=kv.device),
                            cache_len)
    out = torch.zeros_like(tail)
    out[:, slots] = tail
    return out


# --------------------------------------------------------------------------- #
# Zygarde agile (unit-wise) execution.
# --------------------------------------------------------------------------- #


def get_block(cfg, params, i: int):
    """Return (kind, block-params) for absolute layer index ``i``."""
    period, n_scan, rem_kinds = _layer_plan(cfg)
    if i < n_scan * period:
        q, r = i % period, i // period
        return cfg.layer_kind(q), _index(params["layers"]["stack"][q], r)
    return (rem_kinds[i - n_scan * period],
            params["layers"]["rem"][i - n_scan * period])


def unit_layers(cfg, unit: int) -> range:
    lo = unit * cfg.exit_every
    hi = min(cfg.n_layers, lo + cfg.exit_every)
    return range(lo, hi)


def unit_forward(cfg, params, x: torch.Tensor, unit: int, *, enc_out=None,
                 window: Optional[int] = None):
    """Run one Zygarde unit over hidden states x: (B, S, D).

    Returns (x, pooled_features (B, D) f32) — the features feed the
    per-unit k-means classifier + utility test.
    """
    if enc_out is not None:
        raise _unported("xattn")
    for i in unit_layers(cfg, unit):
        kind, bp = get_block(cfg, params, i)
        x, _, _ = block_seq(bp, cfg, kind, x, window=window)
    pooled = torch.mean(x.to(_F32), dim=1)
    return x, pooled


def embed_inputs(cfg, params, batch: dict) -> Tuple[torch.Tensor, Any]:
    """Embedding shared by the agile execution paths: (x, enc_out=None)."""
    _check_batch(cfg, batch)
    return _embed(cfg, params, batch["tokens"]), None


def readout(cfg, params, x: torch.Tensor) -> torch.Tensor:
    return _readout(cfg, params, x)
