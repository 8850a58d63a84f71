"""GQA attention: block-sparse chunked prefill + single-token decode (port
of :mod:`repro.models.attention`).

:func:`chunked_attention` follows the tensor's device, as every kernel of
the port does: a CUDA tensor launches kernel G
(:func:`repro_torch.kernels.ops.flash_attention`) and casts its f32 output
to ``q``'s dtype, as the reference's TPU branch does; a CPU tensor runs the
port of the reference's XLA path (a static list of the (query-chunk,
kv-chunk) pairs inside the causal / window footprint, scanned with an
online-softmax carry), so the CPU port tracks the JAX function the tests
call.  :func:`decode_attention` does the same with kernel H
(:func:`repro_torch.kernels.ops.decode_gqa` with ``round_p=True``: the
normalised softmax rounded to the cache's dtype before the PV product, as
the reference's ``p.astype(v_cache.dtype)``), its output cast to ``q``'s
dtype; a CPU tensor keeps the plain einsum path.  The reference computes
``decode_attention`` with einsums and never reaches its Pallas kernel; the
port takes the kernel's place on the card as it does for
``chunked_attention``.

Both paths are differentiable: on the card kernel G runs under its
``autograd.Function`` with the backward kernel when a gradient is needed
(:mod:`repro_torch.kernels.flash_attn`); the CPU path keeps its online
softmax carry per query chunk in lists and rebinds it, never writing in
place, so autograd follows it (the arithmetic and its order are the
reference's, so every forward bit is as before).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from .common import block_sum

NEG_INF = -1e30
_F32 = torch.float32
#: devices that take the card's kernels; ``meta`` follows the card so that
#: a step lowered on it counts kernels G and H as the card runs them
_CARD_ROUTE = ("cuda", "meta")


def _block_pairs(n_chunks: int, chunk: int, window: int) -> np.ndarray:
    """Static (i, j) list of blocks inside the causal/window footprint."""
    pairs = []
    for i in range(n_chunks):
        if window:
            # query positions in chunk i attend back at most `window` tokens
            j_lo = max(0, (i * chunk + chunk - 1 - window) // chunk)
        else:
            j_lo = 0
        for j in range(j_lo, i + 1):
            pairs.append((i, j))
    return np.asarray(pairs, dtype=np.int32)


def chunk_size(S: int, Skv: int, chunk: int) -> int:
    """The chunk the CPU path of :func:`chunked_attention` uses: ``chunk``
    cut to the lengths and halved until it divides both.  With a window
    that is no multiple of it, the reference's XLA path drops keys from the
    first rows of each query chunk (its block list starts at the block the
    chunk's last row needs), where kernel G on the card keeps them."""
    chunk = min(chunk, S, Skv)
    while S % chunk or Skv % chunk:
        chunk //= 2
    return chunk


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, Skv, KV, hd) -> (B, S, H, hd) in ``q``'s
    dtype.  ``q_offset`` shifts query positions (cross-attention uses
    ``causal=False``)."""
    if q.device.type in _CARD_ROUTE:
        o = kops.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
        return o.to(q.dtype)
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if not causal and not window:
        # encoder / cross-attention: dense (Skv is small for our shapes)
        return _dense_attention(q, k, v)

    chunk = chunk_size(S, Skv, chunk)
    nq, nkv = S // chunk, Skv // chunk
    assert nq == nkv, "causal chunked attention expects S == Skv"
    G = H // KV
    scale = hd ** -0.5

    qb = q.reshape(B, nq, chunk, KV, G, hd)
    kb = k.reshape(B, nkv, chunk, KV, hd)
    vb = v.reshape(B, nkv, chunk, KV, hd)

    # the carry of each query chunk, rebound (never written in place) so
    # that autograd can differentiate the loop
    o = [torch.zeros((B, chunk, KV, G, hd), dtype=_F32, device=q.device)
         for _ in range(nq)]
    m = [torch.full((B, chunk, KV, G), NEG_INF, dtype=_F32, device=q.device)
         for _ in range(nq)]
    l = [torch.zeros((B, chunk, KV, G), dtype=_F32, device=q.device)
         for _ in range(nq)]
    pos_in_chunk = torch.arange(chunk, device=q.device)

    for i, j in _block_pairs(nq, chunk, window).tolist():
        qi, kj, vj = qb[:, i], kb[:, j], vb[:, j]
        # scores: (B, chunk_q, KV, G, chunk_k)
        s = torch.einsum("bqkgh,bckh->bqkgc", qi.to(_F32),
                         kj.to(_F32)) * scale
        qpos = i * chunk + pos_in_chunk + q_offset
        kpos = j * chunk + pos_in_chunk
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] <= window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)

        m_new = torch.maximum(m[i], s.amax(dim=-1))
        alpha = torch.exp(m[i] - m_new)
        p = torch.exp(s - m_new[..., None])
        l[i] = l[i] * alpha + p.sum(dim=-1)
        o[i] = o[i] * alpha[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p, vj.to(_F32))
        m[i] = m_new

    out = torch.stack(o, 1) / torch.clamp(torch.stack(l, 1)[..., None],
                                          min=1e-30)
    return out.reshape(B, S, H, hd).to(q.dtype)


def _dense_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,bckh->bqkgc", qg.to(_F32), k.to(_F32)) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckh->bqkgh", p, v.to(_F32))
    return o.reshape(B, S, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     my_pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Single-token attention against a (ring-buffer) KV cache.

    q: (B, H, hd); k_cache/v_cache: (B, C, KV, hd); slot_pos: (B, C)
    absolute position stored in each slot (-1 = empty); my_pos: (B,) the
    query token's position.  Operands in their own dtype with f32 sums (a
    bf16 product is exact in f32), scores and softmax in f32.
    """
    if q.device.type in _CARD_ROUTE:
        o = kops.decode_gqa(q, k_cache, v_cache, slot_pos, my_pos,
                            window=window, round_p=True)
        return o.to(q.dtype)
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bckh->bkgc", qg.to(_F32),
                     k_cache.to(_F32)) * scale
    valid = (slot_pos >= 0) & (slot_pos <= my_pos[:, None])
    if window:
        valid = valid & (my_pos[:, None] - slot_pos <= window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckh->bkgh", p.to(v_cache.dtype).to(_F32),
                     v_cache.to(_F32))
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_slices(q: torch.Tensor, k_slices, v_slices, sp_slices,
                            my_pos: torch.Tensor,
                            window: int = 0) -> torch.Tensor:
    """:func:`decode_attention` against a cache cut by length into slices,
    one per mesh block, each on its block's device (``sp_slices`` the
    positions of each slice's slots; ``q`` and ``my_pos`` whole).

    Every block's row max, f64 denominator and masked scores (kernel H's
    stats entry), the stats merged in block order on the first block's
    device (its merge entry), then every block's PV sums from its kept
    scores under the merged max and denominator (its PV entry), added in
    block order (:func:`repro_torch.models.common.block_sum`).  On the CPU
    the entries run their plain versions.  Returns ``(B, H, hd)`` in
    ``q``'s dtype on the first block's device."""
    dev = k_slices[0].device
    stats = [kops.decode_gqa_stats(q.to(k.device), k, sp,
                                   my_pos.to(k.device), window=window)
             for k, sp in zip(k_slices, sp_slices)]
    m, l = kops.decode_gqa_merge(torch.stack([s[0].to(dev) for s in stats]),
                                 torch.stack([s[1].to(dev) for s in stats]))
    parts = [kops.decode_gqa_pv(st[2], v, m.to(v.device), l.to(v.device))
             for st, v in zip(stats, v_slices)]
    return block_sum(parts).to(q.dtype)
