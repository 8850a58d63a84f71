"""One-token GQA attention against a ring-buffer KV cache (kernel H).

Replaces the Pallas TPU kernel ``repro/kernels/decode_gqa.py:decode_gqa``:
``q`` ``(B, H, hd)``, caches ``(B, C, KV, hd)``, ``slot_pos`` ``(B, C)``
(the absolute position in each slot, -1 = empty) and ``my_pos`` ``(B,)``
-> ``(B, H, hd)`` f32, the ``G = H // KV`` query heads of a kv head sharing
its cache.  Scores are f32 ``q . k * hd**-0.5``; a slot is valid iff ``0 <=
slot <= pos`` (and ``pos - slot <= window`` when ``window``); invalid
scores are ``-1e30``.  Two functions, chosen by ``round_p``:

* ``round_p=False`` is the Pallas kernel's: ``sum_c exp(s_c - m) v_c /
  max(l, 1e-30)`` with ``l = sum_c exp(s_c - m)``, the division last.  A
  query that sees no valid slot takes ``p = 1`` on every slot, as the
  reference's online softmax does while its running max is still
  ``-1e30``, and its ``l`` is the reference's padded slot count (``C``
  rounded up to its 512-slot tile): the mean of ``v`` over that count.
* ``round_p=True`` is the model's :func:`repro_torch.models.attention
  .decode_attention`: the normalised softmax ``p = exp(s - m) / l`` is
  rounded to the cache's dtype before the PV product (the reference's
  ``p.astype(v_cache.dtype)``).  A query that sees no valid slot gets the
  softmax of all ``-1e30``: ``p = 1 / C`` on every slot.

Both need the row max (and for ``round_p`` the denominator) over all valid
slots before the PV product, so both versions take two passes over the
cache instead of the online update; the result differs from the online form
only by rounding.  The CUDA kernel (``csrc/decode_gqa.cu``) reads bf16 or
f32 caches as stored; where the ``B * KV`` (row, kv head) pairs leave SMs
idle it splits the cache into chunks across blocks (:func:`split_plan`)
and combines the chunks' maxima, f64 sums and PV sums in a fixed order.
:func:`decode_gqa_plain` computes the same function with PyTorch ops and
the kernel's weights: each score is the same sequential chain of fused
multiply-adds over ``hd`` (:func:`~repro_torch.core._fma.fma_f32`),
``exp`` and the denominator are taken in f64 and rounded to f32
(order-independent at f32 precision), so ``p`` agrees bit for bit, also
after its rounding to bf16, whatever the split; the two differ only in the
summation order of the PV product.

A ``meta`` tensor takes the card's route and gets an empty ``meta`` output,
with no launch counted; the op counter counts each call as one item of
:func:`work` (every slot on ``meta``, the kept slots on data).
"""
from __future__ import annotations

import ctypes

import torch

from ..core._fma import fma_f32
from . import _build, _cost

#: launches of the CUDA kernel (the plain version never counts)
launches = 0

NEG = -1e30
#: the reference's cache tile (``choose_block(C, 512)``)
REF_BLOCK_C = 512
#: the largest head dim and query-group size the kernel takes
MAX_HEAD_DIM = 256
MAX_GROUP = 32
#: cache slots per tile of the kernel; a chunk of a split is whole tiles
TILE = 64
#: blocks per SM a split aims at (a block is 256 threads)
BLOCKS_PER_SM = 4

_SMS: dict[int, int] = {}


def split_plan(B: int, KV: int, C: int, sms: int) -> tuple[int, int]:
    """``(nsplit, chunk)``: the kernel cuts each (row, kv head)'s cache of
    ``C`` slots into ``nsplit`` chunks of ``chunk`` slots (whole tiles, the
    last chunk ragged), up to :data:`BLOCKS_PER_SM` blocks on each of the
    card's ``sms`` SMs.  One chunk when the ``B * KV`` pairs fill the SMs
    or the cache is a single tile."""
    tiles = -(-C // TILE)
    n = min(BLOCKS_PER_SM * sms // (B * KV), tiles) if B * KV < sms else 1
    if n <= 1:
        return 1, C
    chunk = TILE * -(-tiles // n)
    return -(-C // chunk), chunk


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _ref_slot_count(c: int) -> int:
    """The reference's padded slot count: ``C`` rounded up to its tile."""
    bc = min(REF_BLOCK_C, c)
    return -(-c // bc) * bc


def kept_slots(slot_pos: torch.Tensor, my_pos: torch.Tensor,
               window: int = 0) -> torch.Tensor:
    """``(B, C)`` bool: the slots each row's query sees."""
    slot_pos, my_pos = slot_pos.to(torch.int64), my_pos.to(torch.int64)
    valid = (slot_pos >= 0) & (slot_pos <= my_pos[:, None])
    if window:
        valid = valid & (my_pos[:, None] - slot_pos <= window)
    return valid


def work(B: int, H: int, KV: int, hd: int, C: int, dtype: torch.dtype, *,
         n_valid: int | None = None) -> _cost.Work:
    """One call: q, the int32 positions and the k and v rows of the
    ``n_valid`` kept (row, slot) pairs (every slot when None) read once,
    the f32 output written once; 4 * H * hd flops per kept pair (the two
    products, on the CUDA cores)."""
    n_valid = B * C if n_valid is None else n_valid
    es = dtype.itemsize
    return _cost.Work(
        bytes=B * H * hd * es + 4 * B * (C + 1) + 2 * n_valid * KV * hd * es
        + 4 * B * H * hd,
        ops=4.0 * H * hd * n_valid, dot=True)


def _call_work(q, k_cache, v_cache, slot_pos, my_pos, *, result, window=0,
               round_p=False):
    B, H, hd = q.shape
    n_valid = (None if q.device.type == "meta"
               else int(kept_slots(slot_pos, my_pos, window).sum()))
    return work(B, H, k_cache.shape[2], hd, k_cache.shape[1], q.dtype,
                n_valid=n_valid)


def decode_gqa_plain(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     my_pos: torch.Tensor, *, window: int = 0,
                     round_p: bool = False) -> torch.Tensor:
    """The plain PyTorch version: the whole cache at once, two passes."""
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = q.to(f32).reshape(B, KV, G, hd)
    kt = k_cache.to(f32).permute(0, 2, 3, 1)[:, :, None]   # (B, KV, 1, hd, C)
    s = torch.zeros((B, KV, G, C), dtype=f32, device=q.device)
    for d in range(hd):      # the kernel's order: d = 0 .. hd-1, one rounding
        s = fma_f32(qg[..., d, None], kt[..., d, :], s)
    s = s * hd ** -0.5
    valid = kept_slots(slot_pos, my_pos, window)
    s = torch.where(valid[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m).to(torch.float64)).to(f32)
    l = p.to(torch.float64).sum(dim=-1, keepdim=True).to(f32)
    if round_p:
        p = (p / l).to(v_cache.dtype).to(f32)
        o = torch.einsum("bkgc,bckh->bkgh", p, v_cache.to(f32))
    else:
        l = torch.where(m == NEG, float(_ref_slot_count(C)), l)
        o = torch.einsum("bkgc,bckh->bkgh", p, v_cache.to(f32))
        o = o / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, hd)


def _check(q, k_cache, v_cache, slot_pos, my_pos):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("decode_gqa: q (B, H, hd), caches (B, C, KV, hd)")
    B, H, hd = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or H % k_cache.shape[2]
            or slot_pos.shape != (B, k_cache.shape[1])
            or my_pos.shape != (B,)):
        raise ValueError(
            f"decode_gqa: q {tuple(q.shape)}, caches {tuple(k_cache.shape)}"
            f"/{tuple(v_cache.shape)}, slot_pos {tuple(slot_pos.shape)}, "
            f"my_pos {tuple(my_pos.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("decode_gqa takes float32 or bfloat16 q and caches "
                        "of one dtype")
    if slot_pos.dtype.is_floating_point or my_pos.dtype.is_floating_point:
        raise TypeError("decode_gqa takes integer slot_pos and my_pos")
    if len({t.device for t in (q, k_cache, v_cache, slot_pos,
                               my_pos)}) != 1:
        raise ValueError("decode_gqa: inputs on different devices")


_LAUNCH = None


def _launcher():
    """``decode_gqa_launch`` of the built library, its prototype set once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("decode_gqa").decode_gqa_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


@_cost.counted("decode_gqa", _call_work)
def decode_gqa(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, slot_pos: torch.Tensor,
               my_pos: torch.Tensor, *, window: int = 0,
               round_p: bool = False) -> torch.Tensor:
    """``(B, H, hd)`` f32 attention output.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (``hd <= 256``, ``G = H //
    KV <= 32``; positions are cast to int32).  The kernel has no backward:
    under autograd, with an input that needs a gradient, a CUDA call
    raises rather than return a tensor without a graph.  A ``meta``
    tensor takes the CUDA route and launches nothing."""
    global launches
    _check(q, k_cache, v_cache, slot_pos, my_pos)
    if q.device.type == "cpu":
        return decode_gqa_plain(q, k_cache, v_cache, slot_pos, my_pos,
                                window=window, round_p=round_p)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_gqa: unsupported device {q.device}")
    _build.no_grad_inputs("decode_gqa", q, k_cache, v_cache)
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if hd > MAX_HEAD_DIM or G > MAX_GROUP:
        raise ValueError(f"decode_gqa: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM} and G <= {MAX_GROUP}; got hd={hd},"
                         f" G={G}")
    if C == 0:
        raise ValueError("decode_gqa: an empty cache")
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or q.device.type == "meta":
        return out
    q, k_cache, v_cache = (q.contiguous(), k_cache.contiguous(),
                           v_cache.contiguous())
    slot_pos = slot_pos.to(torch.int32).contiguous()
    my_pos = my_pos.to(torch.int32).contiguous()
    nsplit, chunk = split_plan(B, KV, C, _sm_count(q.device))
    # the scratch between the kernel's passes, one allocation: the f64 sum
    # of p of each (row, kv head, head, chunk), then in f32 the scores and
    # weights of every (row, kv head, head, slot), each chunk's max and its
    # PV sums (the per-chunk parts are empty without a split)
    n = B * KV * G
    ns = nsplit if nsplit > 1 else 0
    buf = torch.empty(2 * n * ns + n * C + n * ns + n * ns * hd,
                      dtype=torch.float32, device=q.device)
    base = buf.data_ptr()
    psum = base
    scratch = psum + 8 * n * ns
    pmax = scratch + 4 * n * C
    ppv = pmax + 4 * n * ns
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        slot_pos.data_ptr(), my_pos.data_ptr(), B, C, H, KV, hd, int(window),
        int(round_p), hd ** -0.5, float(_ref_slot_count(C)),
        1 if q.dtype == torch.bfloat16 else 0, nsplit, chunk, scratch, pmax,
        psum, ppv, out.data_ptr(), _build.stream_handle(q.device))
    _build.check(err, "decode_gqa")
    launches += 1
    return out
