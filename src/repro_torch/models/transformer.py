"""Model assembly for every family of the model zoo (port of
:mod:`repro.models.transformer`): dense attention, the MoE FFN
(:mod:`repro_torch.models.moe`), the RG-LRU hybrid
(:mod:`repro_torch.models.rglru`), the xLSTM blocks
(:mod:`repro_torch.models.xlstm`), the encoder-decoder (a bidirectional
encoder over stub frame embeddings, cross-attention in every decoder block)
and the VLM (stub patch embeddings prepended to the text).

Parameters keep the reference's stacked layout, so a converted JAX pytree
drops straight in (:func:`repro_torch.convert.transformer_params`):
``params["layers"]["stack"]`` is a tuple over the block pattern's period
of dicts whose leaves carry a leading ``(n_scan, ...)`` layer axis, and
``params["layers"]["rem"]`` holds the remainder blocks; an encoder-decoder
adds ``params["enc"]`` (its stacked blocks and final norm) and, with the
VLM, ``params["frontend_proj"]``.  The reference scans over the layer axis
under ``jit``; the port loops over it eagerly.  Activation checkpointing
follows the reference's: when autograd needs a parameter's gradient,
:func:`forward` with ``remat`` runs the stacked layers in groups of
``cfg.remat_every`` periods, each under ``torch.utils.checkpoint`` (the
backward re-runs a group's forward instead of keeping every layer's
saves), and ``cfg.remat_attention`` checkpoints the CPU path's attention
call on its own; kernel G on the card already saves only ``q``, ``k``,
``v``, its output and the rows' log-sum-exp.  Serving (no gradient) runs
no checkpoint.  JAX's arrays are immutable; the port's functions return
new state dicts too (a KV-cache write copies the cache of that layer), so
a caller's state is never changed in place.

Public entry points:
    init_params / forward / prefill / decode_step / init_decode_state
    unit_forward (Zygarde agile execution: one unit = ``exit_every`` blocks)
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from . import moe as moe_mod
from . import rglru as rg
from . import xlstm as xl
from .attention import (chunked_attention, decode_attention,
                        decode_attention_slices)
from .common import (
    apply_norm,
    apply_rope,
    activate,
    block_layout,
    blocks_of,
    dense_init,
    dtype_of,
    embed_init,
    norm_init,
    place_like,
    replace_blocks,
    scaled_normal,
    ShapeOnly,
    whole_of,
    zeros,
)

_F32 = torch.float32
_I32 = torch.int32


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


def init_block(g, cfg, kind: str, *, cross: bool = False) -> dict:
    """One block's parameters; ``cross`` adds the decoder's cross-attention
    (``norm_x``, ``xattn``) to an ``"attn"`` block."""
    dtype = dtype_of(cfg)
    d = cfg.d_model
    dev = g.device
    p: dict = {"norm1": norm_init(cfg.norm, d, dtype, dev)}
    if kind == "attn":
        p["attn"] = _init_attn(g, cfg, dtype)
        p["norm2"] = norm_init(cfg.norm, d, dtype, dev)
        if cfg.n_experts:
            p["moe"] = moe_mod.init_moe(g, cfg, dtype)
        elif cfg.d_ff:
            p["ffn"] = _init_ffn(g, cfg, dtype)
        if cross:
            p["norm_x"] = norm_init(cfg.norm, d, dtype, dev)
            p["xattn"] = _init_attn(g, cfg, dtype)
    elif kind == "rec":
        w = cfg.resolved_rglru_width
        p["gate_proj"] = dense_init(g, d, (w,), dtype)
        p["rec_proj"] = dense_init(g, d, (w,), dtype)
        p["conv"] = rg.init_conv1d(g, w, cfg.conv1d_width, dtype)
        p["rglru"] = rg.init_rglru(g, w, dtype, n_blocks=cfg.n_heads)
        p["out_proj"] = dense_init(g, w, (d,), dtype)
        p["norm2"] = norm_init(cfg.norm, d, dtype, dev)
        if cfg.d_ff:
            p["ffn"] = _init_ffn(g, cfg, dtype)
    elif kind == "mlstm":
        p["cell"] = xl.init_mlstm(g, d, cfg.n_heads, dtype)
    elif kind == "slstm":
        p["cell"] = xl.init_slstm(g, d, cfg.n_heads, dtype)
    else:
        raise ValueError(kind)
    return p


# --------------------------------------------------------------------------- #
# Block application — full-sequence (train / prefill).
# --------------------------------------------------------------------------- #


def _qkv(p: dict, cfg, h: torch.Tensor, positions: torch.Tensor,
         kv: Optional[tuple[int, int]] = None):
    """q, k, v of ``h`` (RoPE at ``positions``); ``kv = (k0, k1)`` gives
    only kv heads ``k0 .. k1 - 1`` and their query heads, from column
    slices of the projections (a mesh block's heads)."""
    if kv is not None:
        G = p["wq"].shape[1] // p["wk"].shape[1]
        qs, ks = slice(kv[0] * G, kv[1] * G), slice(*kv)
        p = {n: (w[:, qs] if n == "wq" else w[qs] if n == "bq" else
                 w[:, ks] if n in ("wk", "wv") else w[ks])
             for n, w in p.items() if n in ("wq", "wk", "wv", "bq", "bk",
                                            "bv")}
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
    aux = torch.zeros((), dtype=_F32, device=x.device)
    if kind == "rec":
        x, _, _ = _rec_seq(p, cfg, x, scanned)
        return x, aux, None
    if kind in ("mlstm", "slstm"):
        x, _ = _xlstm_seq(p, cfg, kind, x)
        return x, aux, None
    if kind != "attn":
        raise ValueError(kind)
    cache = None
    B, S, D = x.shape
    window = cfg.window if window is None else window
    h = apply_norm(cfg.norm, p["norm1"], x)
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p["attn"], cfg, h, positions)
    attn = functools.partial(chunked_attention, causal=causal, window=window,
                             chunk=cfg.attn_chunk)
    if (cfg.remat_attention and q.device.type == "cpu"
            and torch.is_grad_enabled() and q.requires_grad):
        # the CPU path keeps each chunk's probabilities for its backward;
        # kernel G on the card keeps only its inputs, output and lse
        o = _checkpoint(attn, q, k, v)
    else:
        o = attn(q, k, v)
    x = x + torch.einsum("bsnh,nhd->bsd", o, p["attn"]["wo"])
    if collect_cache:
        cache = (k, v)
    if "xattn" in p:
        if enc_out is None:
            raise ValueError("a cross-attention block needs enc_out")
        hx = apply_norm(cfg.norm, p["norm_x"], x)
        qx = torch.einsum("bsd,dnh->bsnh", hx, p["xattn"]["wq"])
        kx, vx = _cross_kv(p, enc_out)
        ox = chunked_attention(qx, kx, vx, causal=False, window=0)
        x = x + torch.einsum("bsnh,nhd->bsd", ox, p["xattn"]["wo"])
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    if "moe" in p:
        y, aux = moe_mod.apply_moe(p["moe"], cfg, h2)
    elif "ffn" in p:
        y = _apply_ffn(p["ffn"], cfg, h2)
    else:
        y = torch.zeros_like(x)
    return x + y, aux, cache


def _cross_kv(p: dict, enc_out: torch.Tensor):
    """The cross-attention's keys and values over the encoder output (no
    RoPE)."""
    return (torch.einsum("bsd,dnh->bsnh", enc_out, p["xattn"]["wk"]),
            torch.einsum("bsd,dnh->bsnh", enc_out, p["xattn"]["wv"]))


def _xlstm_seq(p: dict, cfg, kind: str, x: torch.Tensor):
    """An ``"mlstm"`` / ``"slstm"`` block over a sequence: (x, the cell's
    state after it)."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    seq_fn = xl.mlstm_seq if kind == "mlstm" else xl.slstm_seq
    y, cell = seq_fn(p["cell"], h, cfg.n_heads)
    return x + y, cell


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
    """x: (B, D); state: per-block decode state, its leaves tensors or
    placed over a mesh (see below); pos: (B,) current position;
    ``scanned`` as in :func:`block_seq`."""
    window = cfg.window if window is None else window
    new_state = dict(state)
    if kind == "rec":
        h = apply_norm(cfg.norm, p["norm1"], x)
        gate = F.gelu(torch.einsum("bd,dw->bw", h, p["gate_proj"]),
                      approximate="tanh")
        r = torch.einsum("bd,dw->bw", h, p["rec_proj"])
        r, new_state["buf"], new_state["h"] = _rec_state_step(
            p, r, state["buf"], state["h"], scanned)
        x = x + torch.einsum("bw,wd->bd", gate * r, p["out_proj"])
        if cfg.d_ff:
            h2 = apply_norm(cfg.norm, p["norm2"], x)
            x = x + _apply_ffn(p["ffn"], cfg, h2[:, None])[:, 0]
        return x, new_state
    if kind in ("mlstm", "slstm"):
        h = apply_norm(cfg.norm, p["norm1"], x)
        y, new_state["cell"] = _xlstm_cell_step(p, cfg, kind, h,
                                                state["cell"])
        return x + y, new_state
    if kind != "attn":
        raise ValueError(kind)
    h = apply_norm(cfg.norm, p["norm1"], x)
    o, new_state["k"], new_state["v"] = _attend(
        p["attn"], cfg, h, state["k"], state["v"], pos, window)
    x = x + torch.einsum("bnh,nhd->bd", o, p["attn"]["wo"])
    if "xattn" in p:
        hx = apply_norm(cfg.norm, p["norm_x"], x)
        ox, _, _ = _attend(p["xattn"], cfg, hx, state["xk"], state["xv"],
                           None, 0)
        x = x + torch.einsum("bnh,nhd->bd", ox, p["xattn"]["wo"])
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    if "moe" in p:
        y = moe_mod.apply_moe(p["moe"], cfg, h2[:, None])[0][:, 0]
    elif "ffn" in p:
        y = _apply_ffn(p["ffn"], cfg, h2[:, None])[:, 0]
    else:
        y = torch.zeros_like(x)
    return x + y, new_state


# A decode state placed by :func:`repro_torch.launch.sharding.state_specs`
# holds :class:`~repro_torch.models.common.Sharded` leaves: the batch rows
# cut over ``data``, and over ``model`` the kv heads of the caches (or
# their length where the heads do not divide) and the width of the RG-LRU
# state and the conv buffer.  The step's hidden state, its norms, FFNs and
# MoE (a dispatch group over every slot, as without a mesh) and the
# projections into and out of the state run whole, once: their weights
# are replicated.  What the state splits runs block by block on each
# block's device (:func:`_attend`, :func:`_rec_state_step`); blocks that
# hold the same slices (a leaf the spec replicates over an axis) are
# computed once and copied to each.  An xLSTM cell steps whole and is
# placed again (:func:`_xlstm_cell_step`).  A state that is not placed is
# the one block that holds all of it.


def _row_groups(layout) -> list:
    """A leaf's distinct blocks grouped by their batch rows, in row order:
    ``[(rows slice, [(slices, block indices), ...]), ...]``."""
    groups: dict[tuple, list] = {}
    for sl, idx in layout:
        groups.setdefault((sl[0].start, sl[0].stop), []).append((sl, idx))
    return [(slice(*r), groups[r]) for r in sorted(groups)]


def _on(t: torch.Tensor, dev) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def _params_on(p: dict, dev) -> dict:
    return {n: _on(w, dev) for n, w in p.items()}


def _write_slice(cache: torch.Tensor, val: torch.Tensor,
                 local: torch.Tensor) -> torch.Tensor:
    """:func:`_write_slot` into a slice of a cut cache: ``local`` is each
    row's slot minus the slice's first slot; rows whose slot lies outside
    the slice keep it as it is."""
    n = cache.shape[1]
    inside = (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1).long()
    ar = torch.arange(cache.shape[0], device=cache.device)
    out = cache.clone()
    mask = inside.reshape(inside.shape + (1,) * (val.dim() - 1))
    out[ar, idx] = torch.where(mask, val.to(cache.dtype), out[ar, idx])
    return out


def _attend(p: dict, cfg, h: torch.Tensor, ks, vs,
            pos: Optional[torch.Tensor], window: int):
    """One step's attention over the caches ``ks``/``vs``: with ``pos``
    the self-attention (q, k, v of ``h`` at ``pos``, k and v written into
    the caches), without it the cross-attention (q of ``h``, every encoder
    slot seen).  Over placed caches each block's heads' q, k, v come from
    column slices of the projections, the outputs gathered in head order;
    over a cache cut by length the blocks' stats and PV sums are merged in
    block order (:func:`repro_torch.models.attention.
    decode_attention_slices`).  Returns ``(o (B, H, hd) on h's device, new
    ks, new vs)``."""
    B, C, KV = ks.shape[0], ks.shape[1], ks.shape[2]
    G = p["wq"].shape[1] // KV
    k_blocks, v_blocks = blocks_of(ks), blocks_of(vs)
    new_k, new_v = list(k_blocks), list(v_blocks)
    outs = []
    for rows, group in _row_groups(block_layout(ks)):
        hr = h[rows]
        Br = hr.shape[0]
        if pos is not None:
            pr = pos[rows]
            slot_pos = _slot_positions(pr + 1, C)
        else:
            pr = torch.full((Br,), C, dtype=_I32, device=h.device)
            slot_pos = torch.arange(C, dtype=_I32,
                                    device=h.device).expand(Br, C)

        def qkv(dev, kv=None):
            x = _on(hr, dev)
            if pos is not None:
                q, k, v = _qkv(p, cfg, x[:, None], _on(pr, dev)[:, None], kv)
                return q[:, 0], k[:, 0], v[:, 0]
            wq = p["wq"] if kv is None else p["wq"][:, kv[0] * G:kv[1] * G]
            return torch.einsum("bd,dnh->bnh", x, _on(wq, dev)), None, None

        def keep(idx, kc, vc):
            for i in idx:
                new_k[i] = _on(kc, k_blocks[i].device)
                new_v[i] = _on(vc, v_blocks[i].device)

        head_cut = any(sl[2] != slice(0, KV) for sl, _ in group)
        len_cut = any(sl[1] != slice(0, C) for sl, _ in group)
        if len_cut:
            q, k, v = qkv(h.device)
            kcs, vcs, sps = [], [], []
            for sl, idx in group:
                kb, vb = k_blocks[idx[0]], v_blocks[idx[0]]
                dev, c0 = kb.device, sl[1].start
                if pos is not None:
                    local = _on(torch.remainder(pr, C) - c0, dev)
                    kb = _write_slice(kb, _on(k, dev), local)
                    vb = _write_slice(vb, _on(v, dev), local)
                    keep(idx, kb, vb)
                kcs.append(kb)
                vcs.append(vb)
                sps.append(_on(slot_pos[:, sl[1]].contiguous(), dev))
            o = decode_attention_slices(q, kcs, vcs, sps, pr, window)
        else:
            pieces = []
            for sl, idx in group:
                kb, vb = k_blocks[idx[0]], v_blocks[idx[0]]
                dev = kb.device
                kv = (sl[2].start, sl[2].stop) if head_cut else None
                q, k, v = qkv(dev, kv)
                if pos is not None:
                    slot = _on(torch.remainder(pr, C), dev)
                    kb = _write_slot(kb, k, slot)
                    vb = _write_slot(vb, v, slot)
                    keep(idx, kb, vb)
                pieces.append(decode_attention(
                    q, kb, vb, _on(slot_pos, dev), _on(pr, dev),
                    window if pos is not None else 0))
            o = (pieces[0] if len(pieces) == 1 else
                 torch.cat([_on(t, h.device) for t in pieces], dim=1))
        outs.append(_on(o, h.device))
    o = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    return o, replace_blocks(ks, new_k), replace_blocks(vs, new_v)


def _rglru_cols(p: dict, w0: int, w1: int) -> dict:
    """The RG-LRU parameters of width ``w0 .. w1 - 1`` (whole blocks of its
    block-diagonal gates)."""
    dh = p["wa"].shape[1]
    return {"wa": p["wa"][w0 // dh:w1 // dh], "wx": p["wx"][w0 // dh:w1 // dh],
            "ba": p["ba"][w0:w1], "bx": p["bx"][w0:w1], "lam": p["lam"][w0:w1]}


def _rec_state_step(p: dict, r: torch.Tensor, bufs, hs, scanned: bool):
    """The conv and the RG-LRU of a ``"rec"`` block's step over its
    ``buf``/``h`` (placed alike: rows over ``data``, width over
    ``model``): each block's rows and width slice (whole gate blocks) on
    its device, the outputs gathered by rows and width.  Returns ``(y (B,
    W) on r's device, new buf, new h)``."""
    W = r.shape[1]
    dh = p["rglru"]["wa"].shape[1]
    h_blocks, b_blocks = blocks_of(hs), blocks_of(bufs)
    new_h, new_buf = list(h_blocks), list(b_blocks)
    pieces = []
    for sl, idx in block_layout(hs):
        rows, w0, w1 = sl[0], sl[1].start, sl[1].stop
        if w0 % dh or w1 % dh:
            raise ValueError(
                f"a width slice {w0}:{w1} of the RG-LRU state cuts its "
                f"gate blocks of {dh}")
        hb, bb = h_blocks[idx[0]], b_blocks[idx[0]]
        dev = hb.device
        conv, gates = p["conv"], p["rglru"]
        if (w0, w1) != (0, W):
            conv = {n: w[..., w0:w1] for n, w in conv.items()}
            gates = _rglru_cols(gates, w0, w1)
        c_out, nb = rg.conv1d_step(_params_on(conv, dev),
                                   _on(r[rows, w0:w1], dev), bb)
        y_p, h_p = rg.rglru_step(_params_on(gates, dev), c_out, hb,
                                 scanned=scanned)
        pieces.append((rows, slice(w0, w1), _on(y_p, r.device)))
        for i in idx:
            new_h[i] = _on(h_p, h_blocks[i].device)
            new_buf[i] = _on(nb, b_blocks[i].device)
    if len(pieces) == 1:
        y = pieces[0][2]
    else:
        y = torch.empty(r.shape, dtype=pieces[0][2].dtype, device=r.device)
        for rows, cols, y_p in pieces:
            y[rows, cols] = y_p
    return y, replace_blocks(bufs, new_buf), replace_blocks(hs, new_h)


def _xlstm_cell_step(p: dict, cfg, kind: str, h: torch.Tensor, cell):
    """An xLSTM block's cell over its state (``h`` the normed input),
    stepped whole on ``h``'s device and placed again.  Its products with
    replicated weights (the gates, the sLSTM's ``h @ R``) then take every
    row at once, as without a mesh: a product over fewer rows may round
    otherwise (the CPU's GEMM picks its kernel by the row count), so a
    mesh step does not depend on how the rows are cut."""
    step_fn = xl.mlstm_step if kind == "mlstm" else xl.slstm_step
    leaves = tuple(cell)
    y, new = step_fn(p["cell"], h, cfg.n_heads,
                     tuple(_on(whole_of(c), h.device) for c in leaves))
    new = [place_like(c, n) for c, n in zip(leaves, new)]
    return y, type(cell)(*new) if hasattr(cell, "_fields") else tuple(new)


# --------------------------------------------------------------------------- #
# Whole-model parameters.
# --------------------------------------------------------------------------- #


def _layer_plan(cfg) -> Tuple[int, int, list]:
    period = cfg.pattern_period
    n_scan = cfg.n_layers // period
    rem_kinds = [cfg.layer_kind(n_scan * period + i)
                 for i in range(cfg.n_layers - n_scan * period)]
    return period, n_scan, rem_kinds


def _tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, tuples)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _stack_dicts(blocks: list):
    """Blocks (trees of one structure) stacked leaf by leaf."""
    return _tree_map(lambda *xs: torch.stack(xs), *blocks)


def _index(tree, r: int):
    return _tree_map(lambda a: a[r], tree)


def _init_stacked(make, n: int):
    """``n`` blocks from ``make()`` stacked leaf by leaf, each block copied
    into its slot as soon as it is drawn: the stack never exists twice
    (a whole dbrx-132b layer is ~6.5 GB in bf16)."""
    stacked = None
    for r in range(n):
        blk = make()
        if stacked is None:
            stacked = _tree_map(lambda a: a.new_empty((n, *a.shape)), blk)
        _tree_map(lambda dst, src: dst[r].copy_(src), stacked, blk)
        del blk
    return stacked


def init_params(cfg, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda") -> dict:
    """Random parameters in the reference's layout and distributions, drawn
    from ``generator`` (default: a fresh one on ``device`` seeded with
    ``seed``); the parameters live on the generator's device.  On
    ``device="meta"`` nothing is drawn: the tree holds the shapes and
    dtypes only (:class:`~repro_torch.models.common.ShapeOnly`)."""
    if generator is None:
        generator = (ShapeOnly() if torch.device(device).type == "meta"
                     else torch.Generator(device=device).manual_seed(seed))
    g = generator
    dtype = dtype_of(cfg)
    period, n_scan, rem_kinds = _layer_plan(cfg)
    cross = cfg.is_encoder_decoder
    stack = tuple(
        _init_stacked(lambda q=q: init_block(g, cfg, cfg.layer_kind(q),
                                             cross=cross), n_scan)
        for q in range(period))
    rem = tuple(init_block(g, cfg, kind, cross=cross) for kind in rem_kinds)
    params = {
        "embed": embed_init(g, cfg.padded_vocab, cfg.d_model, dtype),
        "layers": {"stack": stack, "rem": rem},
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, g.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, cfg.d_model, (cfg.padded_vocab,),
                                       dtype)
    if cfg.n_frontend_tokens or cfg.is_encoder_decoder:
        params["frontend_proj"] = dense_init(g, cfg.d_model, (cfg.d_model,),
                                             dtype)
    if cfg.is_encoder_decoder:
        params["enc"] = {
            "stack": _init_stacked(lambda: init_block(g, cfg, "attn"),
                                   cfg.n_enc_layers),
            "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, g.device),
        }
    return params


# --------------------------------------------------------------------------- #
# Full-sequence forward (prefill).
# --------------------------------------------------------------------------- #


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over stubbed frontend embeddings (B, F, D)."""
    x = torch.einsum("bsd,de->bse", frames.to(dtype_of(cfg)),
                     params["frontend_proj"])
    enc = params["enc"]
    for r in range(cfg.n_enc_layers):
        x, _, _ = block_seq(_index(enc["stack"], r), cfg, "attn", x,
                            causal=False, window=0)
    return apply_norm(cfg.norm, enc["final_norm"], x)


def embed_inputs(cfg, params, batch: dict) -> Tuple[torch.Tensor, Any]:
    """Embedding (+ frontend) shared by every sequence path: ``(x,
    enc_out)``.  An encoder-decoder encodes ``batch["frontend"]`` (its
    frames); a VLM given ``batch["frontend"]`` (its patches) prepends their
    projection to the text, so ``x`` holds ``F + S`` positions."""
    x = _embed(cfg, params, batch["tokens"])
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(cfg, params, batch["frontend"])
    elif cfg.n_frontend_tokens and "frontend" in batch:
        fx = torch.einsum("bsd,de->bse", batch["frontend"].to(x.dtype),
                          params["frontend_proj"])
        x = torch.cat([fx, x], dim=1)
    return x, enc_out


def _blocks(cfg, params):
    """(kind, block params) for every layer in order."""
    for i in range(cfg.n_layers):
        yield get_block(cfg, params, i)


def _head(cfg, params) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _readout(cfg, params, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return torch.einsum("bsd,dv->bsv", x, _head(cfg, params)).to(_F32)


def _checkpoint(fn, *args):
    """``fn(*args)`` under activation checkpointing: only ``args`` are kept
    for the backward, which re-runs ``fn`` (nothing ``fn`` computes draws
    random numbers, so no generator state is kept)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _needs_grad(params) -> bool:
    """Whether autograd will want a gradient of a parameter of ``params``."""
    if not torch.is_grad_enabled():
        return False
    found = []
    _tree_map(lambda a: found.append(a.requires_grad), params)
    return any(found)


def forward(cfg, params, batch: dict, *, window: Optional[int] = None,
            remat: bool = True):
    """batch: {"tokens": (B, S) int32, optional "frontend": (B, F, D)}.
    Returns (logits (B, S_total, V) f32, aux_loss: the MoE layers' sum, f32
    scalar).  The stacked layers run in the reference's groups
    (``_run_stack``): ``remat_every`` periods a group with ``remat`` (one
    period without), the leftover periods as one more group, then the
    remainder blocks.  The reference scans its groups, so their layers are
    ``scanned`` and the leftover's and remainder's are not.  With
    ``remat``, when autograd needs a parameter's gradient, each group
    (the leftover too) runs under a checkpoint that keeps only its input
    ``(x, aux)``; the remainder and the encoder are not checkpointed.
    Recomputation changes no bit."""
    period, n_scan, _ = _layer_plan(cfg)
    k = max(1, cfg.remat_every) if remat else 1
    n_groups = n_scan // k
    x, enc_out = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=_F32, device=x.device)
    stack = params["layers"]["stack"]

    def periods(r0: int, r1: int, scanned: bool, x, aux):
        # the stacked leaves are indexed here, inside a checkpoint, so a
        # group's slices are not kept for the backward
        for r in range(r0, r1):
            for q in range(period):
                x, a, _ = block_seq(_index(stack[q], r), cfg,
                                    cfg.layer_kind(q), x, enc_out=enc_out,
                                    window=window, scanned=scanned)
                aux = aux + a
        return x, aux

    ckpt = remat and _needs_grad(params)
    groups = [(r0, r0 + k, True) for r0 in range(0, n_groups * k, k)]
    if n_groups * k < n_scan:
        groups.append((n_groups * k, n_scan, False))
    for r0, r1, scanned in groups:
        fn = functools.partial(periods, r0, r1, scanned)
        x, aux = _checkpoint(fn, x, aux) if ckpt else fn(x, aux)
    for i in range(n_scan * period, cfg.n_layers):
        kind, bp = get_block(cfg, params, i)
        x, a, _ = block_seq(bp, cfg, kind, x, enc_out=enc_out, window=window)
        aux = aux + a
    return _readout(cfg, params, x), aux


# --------------------------------------------------------------------------- #
# Decode state and serving steps.
# --------------------------------------------------------------------------- #


def _block_state(cfg, kind: str, batch: int, cache_len: int, device, *,
                 cross: bool) -> dict:
    dtype = dtype_of(cfg)
    if kind == "rec":
        w = cfg.resolved_rglru_width
        return {"h": torch.zeros((batch, w), dtype=_F32, device=device),
                "buf": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                   dtype=dtype, device=device)}
    if kind == "mlstm":
        return {"cell": xl.mlstm_init_state(batch, cfg.d_model, cfg.n_heads,
                                            device)}
    if kind == "slstm":
        return {"cell": xl.slstm_init_state(batch, cfg.d_model, cfg.n_heads,
                                            device)}
    if kind != "attn":
        raise ValueError(kind)
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads

    def kv(n):
        return torch.zeros((batch, n, KV, hd), dtype=dtype, device=device)

    st = {"k": kv(cache_len), "v": kv(cache_len)}
    if cross:
        st["xk"], st["xv"] = kv(cfg.n_enc_tokens), kv(cfg.n_enc_tokens)
    return st


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
    per layer (the layout of the unrolled decode and the anytime engine).
    An encoder-decoder's state also holds ``enc_out`` and each block's
    cross-attention keys and values ``xk``/``xv`` (zeros until a
    prefill)."""
    period, n_scan, rem_kinds = _layer_plan(cfg)
    cache_len = cache_len or cache_capacity(cfg, seq_len, window)
    cross = cfg.is_encoder_decoder

    def one(kind):
        return _block_state(cfg, kind, batch, cache_len, device, cross=cross)

    def stacked_state(kind):
        return _tree_map(lambda v: v.expand(n_scan, *v.shape).clone(),
                         one(kind))

    def unstacked_state(kind):
        return tuple(one(kind) for _ in range(n_scan))

    make = stacked_state if stacked else unstacked_state
    state = {
        "pos": torch.zeros((batch,), dtype=_I32, device=device),
        "stack": tuple(make(cfg.layer_kind(q)) for q in range(period)),
        "rem": tuple(one(kind) for kind in rem_kinds),
    }
    if cross:
        state["enc_out"] = torch.zeros(
            (batch, cfg.n_enc_tokens, cfg.d_model), dtype=dtype_of(cfg),
            device=device)
    return state


def _layer_state(cfg, state, i: int) -> dict:
    period, n_scan, _ = _layer_plan(cfg)
    if i >= n_scan * period:
        return state["rem"][i - n_scan * period]
    q, r = i % period, i // period
    st = state["stack"][q]
    return _index(st, r) if isinstance(st, dict) else st[r]


def _assemble_state(cfg, state: dict, pos: torch.Tensor, new_layers: list,
                    stacked: bool) -> dict:
    """``state`` with ``pos`` and one block state per layer, stacked per
    period (``stacked``) or one buffer per layer; its other entries
    (``enc_out``) carry over."""
    period, n_scan, _ = _layer_plan(cfg)
    per_q = [[new_layers[r * period + q] for r in range(n_scan)]
             for q in range(period)]
    stack = tuple(_stack_dicts(states) if stacked else tuple(states)
                  for states in per_q)
    return dict(state, pos=pos, stack=stack,
                rem=tuple(new_layers[n_scan * period:]))


def decode_step(cfg, params, state: dict, token: torch.Tensor, *,
                window: Optional[int] = None, unroll: bool = False):
    """One serving step: token (B,) int32 -> (logits (B, V) f32, new
    state).  Takes both state layouts; ``unroll`` is accepted for the
    reference's signature (the port always runs the layers in order).  A
    stacked state is the reference's scanned decode: its periods run as
    ``scanned`` layers; an unstacked one its unrolled, op-by-op decode."""
    del unroll
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
    return logits, _assemble_state(cfg, state, pos + 1, new_layers, stacked)


def prefill(cfg, params, batch: dict, *, window: Optional[int] = None,
            cache_len: Optional[int] = None):
    """Run the full prompt (and its frontend), returning last-position
    logits + a (stacked) decode state.  Its KV caches hold the last
    ``cache_len`` positions (default: the text's length, capped by the
    window); recurrent blocks hold the RG-LRU's last state and the conv's
    last ``k - 1`` inputs, xLSTM blocks their cells; an encoder-decoder's
    state holds ``enc_out`` and each block's cross keys and values.  For
    full-attention serving pass ``cache_len >= prompt + max_new_tokens``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or cache_capacity(cfg, S, window)
    period, n_scan, _ = _layer_plan(cfg)
    x, enc_out = embed_inputs(cfg, params, batch)
    new_layers = []
    for i, (kind, bp) in enumerate(_blocks(cfg, params)):
        if kind == "rec":
            # the reference scans its periods; the remainder runs op by op
            x, h_last, r = _rec_seq(bp, cfg, x, i < n_scan * period)
            new_layers.append({"h": h_last, "buf": _conv_tail(
                r, bp["conv"]["w"].shape[0])})
            continue
        if kind in ("mlstm", "slstm"):
            x, cell = _xlstm_seq(bp, cfg, kind, x)
            new_layers.append({"cell": cell})
            continue
        x, _, (k, v) = block_seq(bp, cfg, kind, x, enc_out=enc_out,
                                 window=window, collect_cache=True)
        st = {"k": _ring_fill(k, cache_len), "v": _ring_fill(v, cache_len)}
        if "xattn" in bp:
            st["xk"], st["xv"] = _cross_kv(bp, enc_out)
        new_layers.append(st)
    state = {}
    if enc_out is not None:
        state["enc_out"] = enc_out
    pos = torch.full((B,), x.shape[1], dtype=_I32, device=x.device)
    logits = _readout(cfg, params, x[:, -1:])[:, 0]
    return logits, _assemble_state(cfg, state, pos, new_layers,
                                   stacked=True)


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
    for i in unit_layers(cfg, unit):
        kind, bp = get_block(cfg, params, i)
        x, _, _ = block_seq(bp, cfg, kind, x, enc_out=enc_out, window=window)
    pooled = torch.mean(x.to(_F32), dim=1)
    return x, pooled


def readout(cfg, params, x: torch.Tensor) -> torch.Tensor:
    return _readout(cfg, params, x)
