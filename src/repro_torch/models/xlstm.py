"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory with recurrent mixing, sequential) — port of
:mod:`repro.models.xlstm`.

mLSTM recurrence (per head, exponential gating with log-space stabiliser):

    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = f'_t C_{t-1} + i'_t v_t k_t^T        f' = exp(log f + m_{t-1} - m_t)
    n_t = f'_t n_{t-1} + i'_t k_t              i' = exp(log i - m_t)
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

The sequence form is chunkwise-parallel: the state is carried across
chunks of ``min(128, S)`` steps (halved until it divides ``S``), with a
quadratic attention-like product inside each chunk, so the matrix memory
is never formed per step.  Decode is the one-step recurrence.  The sLSTM
runs one step per token (its recurrence mixes ``h_{t-1}`` through ``R``):
an eager loop of small operations, host-bound on the card.  The gate
weights and every state stay f32 in a bf16 model; ``m`` starts at
``-1e30``.  All of it is plain PyTorch, as the reference is plain
``jnp``: no Pallas kernel runs here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, scaled_normal, zeros

CHUNK = 128
_F32 = torch.float32


# --------------------------------------------------------------------------- #
# Parameter init.  Both cells operate on an inner width w = 2 * d_model with
# H heads; the block does d->w up-projection and w->d down-projection.
# --------------------------------------------------------------------------- #


def init_mlstm(g, d_model: int, n_heads: int, dtype) -> dict:
    w = 2 * d_model
    dev = g.device
    return {
        "up": dense_init(g, d_model, (w,), dtype),
        "wq": dense_init(g, w, (w,), dtype),
        "wk": dense_init(g, w, (w,), dtype),
        "wv": dense_init(g, w, (w,), dtype),
        "wi": dense_init(g, w, (n_heads,), _F32),
        "wf": dense_init(g, w, (n_heads,), _F32),
        "bi": zeros((n_heads,), _F32, dev),
        "bf": torch.full((n_heads,), 3.0, dtype=_F32, device=dev),
        "down": dense_init(g, w, (d_model,), dtype),
    }


def init_slstm(g, d_model: int, n_heads: int, dtype) -> dict:
    w = 2 * d_model
    dh = w // n_heads
    dev = g.device
    return {
        "up": dense_init(g, d_model, (w,), dtype),
        "wz": dense_init(g, w, (w,), _F32),
        "wi": dense_init(g, w, (w,), _F32),
        "wf": dense_init(g, w, (w,), _F32),
        "wo": dense_init(g, w, (w,), _F32),
        # recurrent block-diagonal mixing, per head: (H, dh, dh)
        "r": scaled_normal(g, (n_heads, dh, dh), dh ** -0.5, _F32),
        "bf": torch.full((w,), 3.0, dtype=_F32, device=dev),
        "bi": zeros((w,), _F32, dev),
        "down": dense_init(g, w, (d_model,), dtype),
    }


# --------------------------------------------------------------------------- #
# mLSTM — chunkwise-parallel sequence form.
# --------------------------------------------------------------------------- #


def _mlstm_qkvg(p: dict, x: torch.Tensor, n_heads: int):
    u = F.silu(torch.einsum("...d,dw->...w", x, p["up"]))
    w = u.shape[-1]
    dh = w // n_heads

    def heads(t):
        return t.reshape(*t.shape[:-1], n_heads, dh)

    q = heads(torch.einsum("...w,wv->...v", u, p["wq"])) * dh ** -0.5
    k = heads(torch.einsum("...w,wv->...v", u, p["wk"])) * dh ** -0.5
    v = heads(torch.einsum("...w,wv->...v", u, p["wv"]))
    uf = u.to(_F32)
    log_i = torch.einsum("...w,wh->...h", uf, p["wi"]) + p["bi"]
    log_f = F.logsigmoid(torch.einsum("...w,wh->...h", uf, p["wf"])
                         + p["bf"])
    return q, k, v, log_i, log_f


def mlstm_chunk(S: int) -> int:
    """The chunk of :func:`mlstm_seq`: ``min(128, S)`` halved until it
    divides ``S``."""
    chunk = min(CHUNK, S)
    while S % chunk:
        chunk //= 2
    return chunk


def _mlstm_chunk_step(carry, q_, k_, v_, li, lf):
    """One chunk: carry (C, n, m), inputs (B, chunk, H, ...) and (B, chunk,
    H) -> (new carry, h (B, chunk, H, dh) f32)."""
    C, n, m = carry
    q_, k_, v_ = q_.to(_F32), k_.to(_F32), v_.to(_F32)
    chunk = q_.shape[1]
    # cumulative log decay within chunk (inclusive of step t's forget)
    F_ = torch.cumsum(lf, dim=1)                            # (B, chunk, H)
    F_total = F_[:, -1]
    # stabiliser: per-chunk running max of (m + F) and (li + F offsets)
    m_intra = torch.amax(li - lf + F_, dim=1)
    m_new = torch.maximum(m + F_total, m_intra)
    # inter-chunk contribution: h_inter_t = q_t . C * exp(m + F_t - m_t*)
    dec_q = torch.exp(m[:, None] + F_ - m_new[:, None])     # (B, chunk, H)
    h_inter = torch.einsum("bthd,bhde->bthe", q_, C) * dec_q[..., None]
    n_inter = n[:, None] * dec_q[..., None]                 # (B,chunk,H,dh)
    # intra-chunk: s<=t, weight exp(li_s + F_t - F_s - m_t*)
    wmat = (li[:, None, :] - F_[:, None, :] + F_[:, :, None]
            - m_new[:, None, None])                         # (B, t, s, H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q_.device))
    wmat = torch.where(mask[None, :, :, None], torch.exp(wmat), 0.0)
    scores = torch.einsum("bthd,bshd->btsh", q_, k_) * wmat
    h_intra = torch.einsum("btsh,bshd->bthd", scores, v_)
    n_intra = torch.einsum("btsh,bshd->bthd", scores, k_)
    h_num = h_inter + h_intra
    n_vec = n_inter + n_intra
    denom = torch.maximum(
        torch.abs(torch.einsum("bthd,bthd->bth", q_, n_vec)),
        torch.exp(-m_new)[:, None])
    h = h_num / denom[..., None]
    # state update to chunk end
    dec_C = torch.exp(m + F_total - m_new)                  # (B, H)
    dec_k = torch.exp(li + F_total[:, None] - F_ - m_new[:, None])
    C_new = C * dec_C[..., None, None] + torch.einsum(
        "bshd,bsh,bshe->bhde", k_, dec_k, v_)
    n_new = n * dec_C[..., None] + torch.einsum("bshd,bsh->bhd", k_, dec_k)
    return (C_new, n_new, m_new), h


def mlstm_seq(p: dict, x: torch.Tensor, n_heads: int, state=None):
    """x: (B, S, D) -> (y (B, S, D), state (C, n, m))."""
    B, S, D = x.shape
    q, k, v, log_i, log_f = _mlstm_qkvg(p, x, n_heads)
    w = q.shape[-2] * q.shape[-1]
    chunk = mlstm_chunk(S)
    carry = (state if state is not None
             else mlstm_init_state(B, D, n_heads, x.device))
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        carry, h = _mlstm_chunk_step(carry, q[:, sl], k[:, sl], v[:, sl],
                                     log_i[:, sl], log_f[:, sl])
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, w)
    y = torch.einsum("...w,wd->...d", h.to(x.dtype), p["down"])
    return y, carry


def mlstm_step(p: dict, x: torch.Tensor, n_heads: int, state):
    """x: (B, D) -> (y (B, D), state)."""
    q, k, v, log_i, log_f = _mlstm_qkvg(p, x[:, None], n_heads)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    log_i, log_f = log_i[:, 0], log_f[:, 0]
    C, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    f_ = torch.exp(log_f + m - m_new)[..., None]
    i_ = torch.exp(log_i - m_new)[..., None]
    qf, kf, vf = (t.to(_F32) for t in (q, k, v))
    C_new = (C * f_[..., None]
             + i_[..., None] * kf[..., :, None] * vf[..., None, :])
    n_new = n * f_ + i_ * kf
    num = torch.einsum("bhde,bhd->bhe", C_new, qf)
    denom = torch.maximum(
        torch.abs(torch.einsum("bhd,bhd->bh", n_new, qf)), torch.exp(-m_new))
    h = (num / denom[..., None]).reshape(x.shape[0], -1)
    y = torch.einsum("bw,wd->bd", h.to(x.dtype), p["down"])
    return y, (C_new, n_new, m_new)


def mlstm_init_state(batch: int, d_model: int, n_heads: int, device="cuda"):
    w = 2 * d_model
    dh = w // n_heads
    return (torch.zeros((batch, n_heads, dh, dh), dtype=_F32, device=device),
            torch.zeros((batch, n_heads, dh), dtype=_F32, device=device),
            torch.full((batch, n_heads), -1e30, dtype=_F32, device=device))


# --------------------------------------------------------------------------- #
# sLSTM — sequential (the recurrence mixes h_{t-1} through R).
# --------------------------------------------------------------------------- #


def _slstm_cell(p: dict, n_heads: int, u_t: torch.Tensor, carry):
    """u_t: (B, w) pre-activations input; carry: (c, n, m, h)."""
    c, n, m, h = carry
    B, w = u_t.shape
    dh = w // n_heads
    hh = h.reshape(B, n_heads, dh)
    rec = torch.einsum("bhd,hde->bhe", hh, p["r"]).reshape(B, w)
    z = torch.tanh(torch.einsum("bw,wv->bv", u_t, p["wz"]) + rec)
    o = torch.sigmoid(torch.einsum("bw,wv->bv", u_t, p["wo"]) + rec)
    log_i = torch.einsum("bw,wv->bv", u_t, p["wi"]) + p["bi"] + rec
    log_f = F.logsigmoid(torch.einsum("bw,wv->bv", u_t, p["wf"]) + p["bf"]
                         + rec)
    m_new = torch.maximum(log_f + m, log_i)
    f_ = torch.exp(log_f + m - m_new)
    i_ = torch.exp(log_i - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_seq(p: dict, x: torch.Tensor, n_heads: int, state=None):
    """x: (B, S, D) -> (y, state (c, n, m, h))."""
    B, S, D = x.shape
    u = F.silu(torch.einsum("bsd,dw->bsw", x, p["up"])).to(_F32)
    if state is None:
        state = slstm_init_state(B, D, n_heads, x.device)
    hs = []
    for t in range(S):
        state, h = _slstm_cell(p, n_heads, u[:, t], state)
        hs.append(h)
    h = torch.stack(hs, dim=1)
    y = torch.einsum("bsw,wd->bsd", h.to(x.dtype), p["down"])
    return y, state


def slstm_step(p: dict, x: torch.Tensor, n_heads: int, state):
    u = F.silu(torch.einsum("bd,dw->bw", x, p["up"])).to(_F32)
    state, h = _slstm_cell(p, n_heads, u, state)
    y = torch.einsum("bw,wd->bd", h.to(x.dtype), p["down"])
    return y, state


def slstm_init_state(batch: int, d_model: int, n_heads: int, device="cuda"):
    w = 2 * d_model
    z = torch.zeros((batch, w), dtype=_F32, device=device)
    return (z, z.clone(), torch.full((batch, w), -1e30, dtype=_F32,
                                     device=device), z.clone())
