"""Flash (fused online-softmax) GQA attention forward (kernel G).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attn.py:flash_attention``
and computes what it computes: ``q`` ``(B, S, H, hd)``, ``k``/``v``
``(B, Skv, KV, hd)`` -> ``(B, S, H, hd)`` f32, the ``G = H // KV`` query
heads of a kv head sharing it.  Scores are f32 ``q . k * hd**-0.5``;
masked scores (``causal``: ``qpos >= kpos``; ``window``: ``qpos - kpos <=
window``; keys past ``Skv``) are ``-1e30``; the softmax runs online over kv
tiles in ascending order with a running max ``m``, denominator ``l`` and
f32 accumulator, ``p`` is cast to ``v``'s dtype before the PV product (bf16
in, bf16 ``p``, f32 accumulation), and the output is ``acc / max(l,
1e-30)``.  Query positions are shifted by ``q_offset``.

A row whose every key is masked is the one place the tiling shows: the
reference's online softmax then sees ``p = exp(-1e30 + 1e30) = 1`` on every
key of every tile, so it returns the sum of ``v`` over the real keys
divided by its padded key count (``Skv`` rounded up to its 128-key tile).
Both versions here give that value.  The kernel skips the tiles that are
masked for every row of its query tile; the plain version processes every
tile, which changes no bit (such a tile adds exact zeros, or is wiped by
``alpha = 0`` when a live tile comes later).

The CUDA kernels (``csrc/flash_attn.cu``) run one block per (64 query rows
of one batch x kv head: ``P = 64 // G`` positions x ``G`` heads, the last
``64 - P * G`` rows padding that is never stored, so any ``G <= 64``
runs); the kv loop lives inside the block.  The dtype picks the kernel
(:func:`kernel_path`): bf16 runs on the tensor cores (TMA loads of bf16
tiles, ``Q K^T`` on the f64 tensor cores, ``P V`` by ``wgmma`` with f32
accumulators; ``hd`` a multiple of 8), f32 on the CUDA cores (SIMT).
:func:`flash_attention_plain` computes the same function tile by tile in
the same order with PyTorch ops.  It and the bf16 kernel form each score as
the f32 rounding of its exact dot product (bf16 products are exact in f64:
the kernel's f64 tensor cores, the plain version's f64 einsum), so the
bf16 rounding of ``p`` sees the same value in both and they differ only in
the summation order of the PV product; the f32 kernel's scores are f32
fused multiply-add chains, a few ulps from the plain version's.

Training (:class:`_FlashAttention`): under autograd, with an input that
requires a gradient, a CUDA call launches the forward kernel with its rows'
log-sum-exp ``lse = m + log(l)`` as a second, f32 output (``out`` does not
move by one bit) and saves it; the backward launches the two kernels of
``csrc/flash_attn_bwd.cu`` (:func:`flash_attention_bwd`): ``dq`` per query
tile, ``dk`` and ``dv`` per key tile, deterministic, no atomics; in bf16
on the tensor cores (every product a ``wgmma``, ``dout`` rounded to bf16
once by the first launch for both), in f32 on the CUDA cores.
:func:`flash_attention_bwd_plain` computes the same formulas tile by tile;
:func:`bwd_dq_plan` and :func:`bwd_dkdv_plan` list the tiles the bf16
kernels visit.
Without autograd (``torch.no_grad()``, or no input that needs a gradient)
the call launches exactly the forward it launches for serving.

A ``meta`` tensor takes the card's route (through :class:`_FlashAttention`
under autograd) and gets empty ``meta`` outputs of the kernel's shapes and
dtypes, with no launch counted: a step lowered on ``meta`` counts each
call as one item of :func:`work` (:func:`bwd_work` for the backward), as
the card's does.
"""
from __future__ import annotations

import ctypes

import torch

import numpy as np

from . import _build, _cost

#: launches of the CUDA kernel (the plain version never counts)
launches = 0
#: launches of the two backward kernels (two per CUDA call)
bwd_launches = 0

NEG = -1e30
#: query rows (positions x heads of a kv group) and keys per tile; a
#: group of G heads fills ``BLOCK_Q // G * G`` rows of a tile
BLOCK_Q = 64
BLOCK_K = 64
#: the largest head dim the kernel takes
MAX_HEAD_DIM = 256
#: the reference's kv tile (``choose_block(Skv, 128)``)
REF_BLOCK_K = 128
#: the two kernels of ``csrc/flash_attn.cu``, by input dtype
PATHS = {torch.bfloat16: "tensor-core", torch.float32: "simt"}


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """Which kernel a CUDA call of ``dtype`` and head dim ``hd`` launches:
    ``"tensor-core"`` (bf16) or ``"simt"`` (f32).  Raises for what neither
    takes: ``hd > 256``, or bf16 with ``hd`` not a multiple of 8 (the TMA
    copies need rows of whole 16 bytes)."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM}; got hd={hd}")
    path = PATHS[dtype]
    if path == "tensor-core" and hd % 8:
        raise ValueError(f"flash_attention: the bf16 tensor-core kernel "
                         f"takes hd a multiple of 8; got hd={hd}")
    return path


def pairs(S: int, Skv: int, causal: bool, window: int,
          q_offset: int) -> int:
    """Unmasked (query, key) pairs of one head: the useful work."""
    qpos = np.arange(S, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(S, Skv - 1)
    lo = np.maximum(qpos - window, 0) if window else np.zeros(S, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _peak_type(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def work(B: int, S: int, Skv: int, H: int, KV: int, hd: int,
         dtype: torch.dtype, *, causal: bool = True, window: int = 0,
         q_offset: int = 0) -> _cost.Work:
    """One forward call: q, k and v read once, the f32 output written
    once; 4 * hd flops (the two products) per visible pair of each head, at
    the dense peak of the input type."""
    n_q, n_kv = B * S * H * hd, B * Skv * KV * hd
    return _cost.Work(
        bytes=(n_q + 2 * n_kv) * dtype.itemsize + 4 * n_q,
        ops=4.0 * hd * pairs(S, Skv, causal, window, q_offset) * H * B,
        dtype=_peak_type(dtype), dot=True)


def bwd_work(B: int, S: int, Skv: int, H: int, KV: int, hd: int,
             dtype: torch.dtype, *, causal: bool = True, window: int = 0,
             q_offset: int = 0) -> _cost.Work:
    """One backward call: q, k, v, the f32 ``out``, ``dout`` and ``lse``
    read once, dq, dk and dv written once in the input type; 10 * hd flops
    (s, dp, dv, dk, dq) per visible pair of each head."""
    n_q, n_kv = B * S * H * hd, B * Skv * KV * hd
    return _cost.Work(
        bytes=2 * (n_q + 2 * n_kv) * dtype.itemsize + 8 * n_q + 4 * B * S * H,
        ops=10.0 * hd * pairs(S, Skv, causal, window, q_offset) * H * B,
        dtype=_peak_type(dtype), dot=True)


def _call_work(q, k, v, *, result, causal=True, window=0, q_offset=0):
    return work(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], q.dtype, causal=causal, window=window,
                q_offset=q_offset)


def _bwd_call_work(q, k, v, out, lse, dout, *, result, causal=True,
                   window=0, q_offset=0):
    return bwd_work(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], q.dtype, causal=causal, window=window,
                    q_offset=q_offset)


def _ref_kv_count(skv: int) -> int:
    """The reference's padded key count: ``Skv`` rounded up to its tile."""
    bk = min(REF_BLOCK_K, skv)
    return -(-skv // bk) * bk


def _mask(qpos, kpos, skv: int, causal: bool, window: int):
    m = kpos[None, :] < skv
    if causal:
        m = m & (qpos[:, None] >= kpos[None, :])
    if window:
        m = m & (qpos[:, None] - kpos[None, :] <= window)
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, q_offset: int = 0,
                          return_lse: bool = False):
    """The plain PyTorch version: every kv tile of :data:`BLOCK_K` keys in
    ascending order, every query row at once.  A score is the f32 rounding
    of its dot product taken in f64 (exact for bf16 inputs), as the
    kernel's.  With ``return_lse``, ``(out, lse)``: ``lse`` (B, S, H) f32
    is each row's ``m + log(l)`` (``-1e30`` for a row that sees no key)."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = hd ** -0.5
    qf = q.to(torch.float64).reshape(B, S, KV, G, hd)
    qpos = torch.arange(S, device=dev) + q_offset
    m = torch.full((B, S, KV, G), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, KV, G, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, Skv, BLOCK_K):
        kpos = torch.arange(j0, j0 + BLOCK_K, device=dev)
        mask = _mask(qpos, kpos, Skv, causal, window)          # (S, bk)
        kt = k[:, j0:j0 + BLOCK_K].to(torch.float64)
        vt = v[:, j0:j0 + BLOCK_K]
        n = kt.shape[1]
        s = torch.einsum("bqkgh,bckh->bqkgc", qf, kt).to(torch.float32)
        s = s * scale
        s = torch.where(mask[None, :, None, None, :n], s, NEG)
        if n < BLOCK_K:   # the ragged tile's padded keys: masked, v = 0
            s = torch.cat([s, s.new_full((*s.shape[:-1], BLOCK_K - n),
                                         NEG)], dim=-1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckh->bqkgh",
                          p[..., :n].to(v.dtype).to(torch.float32),
                          vt.to(torch.float32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    # rows that never saw a real key: the reference's padded key count
    dead = m == NEG
    l = torch.where(dead, float(_ref_kv_count(Skv)), l)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.reshape(B, S, H, hd)
    if not return_lse:
        return out
    lse = torch.where(dead, NEG, m + torch.log(l))
    return out, lse.reshape(B, S, H)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q (B, S, H, hd), k/v (B, Skv, "
                         "KV, hd)")
    B, S, H, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or H % k.shape[2]):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v "
                        "of one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: inputs on different devices")


_LAUNCH = None


def _launcher():
    """``flash_attn_launch`` of the built library, its prototype set once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("flash_attn").flash_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the TMA copies need both)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal: bool, window: int, q_offset: int,
            with_lse: bool):
    """Kernel G on CUDA tensors: ``(out, lse or None)``; on ``meta``
    tensors the empty outputs, nothing launched."""
    global launches
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    path = kernel_path(q.dtype, hd)
    if G > BLOCK_Q:
        raise ValueError(f"flash_attention: the kernel takes G <= "
                         f"{BLOCK_Q}; got G={G}")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or q.device.type == "meta":
        return out, lse
    q, k, v = _dense(q), _dense(k), _dense(v)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, Skv, H,
                      KV, hd, int(causal), int(window), int(q_offset),
                      hd ** -0.5, int(path == "tensor-core"), out.data_ptr(),
                      _build.stream_handle(q.device),
                      lse.data_ptr() if with_lse else None)
    _build.check(err, "flash_attention")
    launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Kernel G with its gradient: the forward saves ``out`` and the rows'
    log-sum-exp, the backward runs :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _launch(q, k, v, causal, window, q_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None


@_cost.counted("flash_attention", _call_work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """``(B, S, H, hd)`` f32 attention output.  A CPU tensor takes the
    plain version (differentiable by autograd); a CUDA tensor launches the
    kernel of :func:`kernel_path` (``G = H // KV`` up to :data:`BLOCK_Q`),
    through :class:`_FlashAttention` when autograd needs a gradient of an
    input; a ``meta`` tensor takes the CUDA route and launches nothing."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _launch(q, k, v, causal, window, q_offset, False)[0]


# --------------------------------------------------------------------------- #
# The backward.
# --------------------------------------------------------------------------- #


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=0, q_offset=0):
    """The plain PyTorch version of the backward: over kv tiles of
    :data:`BLOCK_K` keys, ``s = q.k * scale`` with the forward's masks,
    ``p = exp(s - lse)`` (0 on masked pairs), ``D = rowsum(dout * out)``,
    ``dv = p^T dout``, ``ds = p * (dout v^T - D)``, ``dk = ds^T q *
    scale``, ``dq = ds k * scale``, all in f32.  A row that sees no key
    (``lse == -1e30``) took the forward's mean of the ``Skv`` real keys
    over :func:`_ref_kv_count`'s ``n``, so it adds ``dout / n`` to ``dv`` at
    each of them (``p = 1 / n`` for ``dv`` alone: its ``ds`` stays 0, so
    ``dq`` and ``dk`` do not move), as ``jax.vjp`` of the reference's dense
    softmax gives where ``n == Skv``.  Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    f32 = torch.float32
    scale = hd ** -0.5
    qf = q.to(f32).reshape(B, S, KV, G, hd)
    go = dout.to(f32).reshape(B, S, KV, G, hd)
    D = (go * out.to(f32).reshape(B, S, KV, G, hd)).sum(-1)
    lse = lse.to(f32).reshape(B, S, KV, G)
    dead = (lse == NEG)[..., None]
    inv_n = (torch.tensor(1.0, dtype=f32) / _ref_kv_count(Skv)).to(dev)
    qpos = torch.arange(S, device=dev) + q_offset
    dq = torch.zeros((B, S, KV, G, hd), dtype=f32, device=dev)
    dk = torch.zeros((B, Skv, KV, hd), dtype=f32, device=dev)
    dv = torch.zeros((B, Skv, KV, hd), dtype=f32, device=dev)
    for j0 in range(0, Skv, BLOCK_K):
        kt = k[:, j0:j0 + BLOCK_K].to(f32)
        vt = v[:, j0:j0 + BLOCK_K].to(f32)
        n = kt.shape[1]
        kpos = torch.arange(j0, j0 + n, device=dev)
        mask = _mask(qpos, kpos, Skv, causal, window)[None, :, None, None]
        s = torch.einsum("bqkgh,bckh->bqkgc", qf, kt) * scale
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dv[:, j0:j0 + n] = torch.einsum(
            "bqkgc,bqkgh->bckh", torch.where(dead, inv_n, p), go)
        dp = torch.einsum("bqkgh,bckh->bqkgc", go, vt)
        ds = p * (dp - D[..., None])
        dk[:, j0:j0 + n] = torch.einsum("bqkgc,bqkgh->bckh", ds, qf) * scale
        dq = dq + torch.einsum("bqkgc,bckh->bqkgh", ds, kt) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bwd_dq_rows(hd: int) -> int:
    """Rows of a dq block of the bf16 backward (``csrc/flash_attn_bwd.cu``:
    ``DqShape``): two warpgroups of 64, one at a padded head dim of 256."""
    return 64 if hd > 128 else 128


def bwd_dq_plan(S: int, Skv: int, G: int, hd: int, causal: bool,
                window: int, q_offset: int):
    """The dq kernel's blocks of one (batch, kv head) in the bf16 backward:
    ``[(first position, end position, [first key of each key tile])]``,
    each block ``bwd_dq_rows(hd) // G`` positions x ``G`` heads, its key
    tiles of :data:`BLOCK_K` the range its rows can see (``dq_tc_kernel``'s
    arithmetic)."""
    ppb = bwd_dq_rows(hd) // G
    plan = []
    for p0 in range(0, S, ppb):
        qmin, qmax = p0 + q_offset, min(p0 + ppb, S) - 1 + q_offset
        k_lo, k_hi = 0, Skv - 1
        if window:
            k_lo = max(0, qmin - window)
        if causal:
            k_hi = min(k_hi, qmax)
        tiles = (list(range(k_lo // BLOCK_K * BLOCK_K, k_hi + 1, BLOCK_K))
                 if k_hi >= k_lo else [])
        plan.append((p0, min(p0 + ppb, S), tiles))
    return plan


def dead_positions(S: int, Skv: int, causal: bool, window: int,
                   q_offset: int):
    """The positions whose rows see no key: ``(pre, suf)``, the prefix
    ``[0, pre)`` (causal rows before key 0, a negative ``q_offset``) and
    the suffix ``[suf, S)`` (window rows past the last key); every other
    row sees a key.  The forward gives these rows ``lse == -1e30``."""
    pre = min(S, max(0, -q_offset)) if causal else 0
    suf = max(pre, min(S, Skv + window - q_offset)) if window else S
    return pre, suf


def bwd_dkdv_plan(S: int, Skv: int, G: int, causal: bool, window: int,
                  q_offset: int):
    """The dk/dv kernel's blocks of one (batch, kv head) in the bf16
    backward: ``[(first key, [first position of each row tile])]``, each
    block :data:`BLOCK_K` keys, its row tiles ``BLOCK_K // G`` positions x
    ``G`` heads over the positions that can see its keys
    (``dkdv_tc_kernel``'s arithmetic).  The rows that see no key
    (:func:`dead_positions`) are added after the tiles."""
    ppb = BLOCK_K // G
    plan = []
    for k0 in range(0, Skv, BLOCK_K):
        k_hi = min(k0 + BLOCK_K, Skv) - 1
        p_lo, p_hi = 0, S - 1
        if causal:
            p_lo = max(0, k0 - q_offset)
        if window:
            p_hi = min(p_hi, k_hi + window - q_offset)
        plan.append((k0, list(range(p_lo, p_hi + 1, ppb))))
    return plan


_BWD = None


def _bwd_launcher():
    """``flash_attn_bwd_launch`` of the built library, bound once."""
    global _BWD
    if _BWD is None:
        fn = _build.load("flash_attn_bwd").flash_attn_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


@_cost.counted("flash_attention_bwd", _bwd_call_work)
def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        q_offset=0):
    """``(dq, dk, dv)`` in the inputs' dtypes from the forward's ``out``
    and ``lse`` and the output's cotangent ``dout``.  A CPU tensor takes
    the plain version; a CUDA tensor launches ``csrc/flash_attn_bwd.cu``
    (two kernels, f32 accumulation, any ``G <= 64`` and ``hd <= 256``,
    the instance of :func:`kernel_path`: bf16 on the tensor cores with
    ``hd`` a multiple of 8, f32 on the CUDA cores); a ``meta`` tensor gets
    empty gradients and launches nothing."""
    global bwd_launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    tc = kernel_path(q.dtype, hd) == "tensor-core"
    if H // KV > BLOCK_Q:
        raise ValueError(f"flash_attention_bwd: G <= {BLOCK_Q}; got "
                         f"G={H // KV}")
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    q, k, v = _dense(q), _dense(k), _dense(v)
    out, lse, dout = (_dense(t.to(torch.float32)) for t in (out, lse, dout))
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, S, H, hd), **f32)
    dk = torch.zeros((B, Skv, KV, hd), **f32)
    dv = torch.zeros((B, Skv, KV, hd), **f32)
    dbuf = torch.empty((B, S, H), **f32)
    # the bf16 copy of dout that the first launch writes for the second
    dob = (_dense(torch.empty((B, S, H, hd), dtype=torch.bfloat16,
                              device=q.device)) if tc else None)
    if dq.numel() and dk.numel():
        err = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), B, S, Skv, H, KV, hd,
            int(causal), int(window), int(q_offset), hd ** -0.5, int(tc),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbuf.data_ptr(),
            dob.data_ptr() if tc else None, _build.stream_handle(q.device))
        _build.check(err, "flash_attention_bwd")
        bwd_launches += 2
    else:
        dq.zero_()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
