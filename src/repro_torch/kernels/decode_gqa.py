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

A cache cut by length over the blocks of a mesh (a model with fewer kv
heads than the mesh's ``model`` axis) needs each row's max and denominator
over every block before a block's PV product, so the kernel has three more
entries for ``round_p=True``: :func:`decode_gqa_stats` (one block's slice:
each (row, head)'s max and f64 sum of ``exp(s - max)``, and the slice's
masked scores, kept), :func:`decode_gqa_merge` (the blocks' stats in block
order: the max of the maxima and the f64 sum of each block's sum rescaled
to it) and :func:`decode_gqa_pv` (one block's PV sums from its kept scores
under the merged max and denominator, so the slice's k rows are read once
per step); the blocks' PV sums are added in block order
(:func:`repro_torch.models.attention.decode_attention_slices`).  The stats
and PV entries cut each slice into :func:`split_plan`'s chunks, as the
whole cache is cut, and combine the chunks' maxima, f64 sums and PV sums
in chunk order.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from ..core._fma import fma_f32
from . import _build, _cost

#: launches of the CUDA kernel's entries (the plain versions never count)
launches = 0
stats_launches = 0
merge_launches = 0
pv_launches = 0

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


# --------------------------------------------------------------------------- #
# A cache slice of a mesh block: stats, merge, PV (round_p=True).
# --------------------------------------------------------------------------- #


def _scores_plain(q, k_cache, slot_pos, my_pos, window):
    """``(B, KV, G, C)`` f32 scores in the kernel's order, ``NEG`` where a
    slot is not kept."""
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    f32 = torch.float32
    qg = q.to(f32).reshape(B, KV, H // KV, hd)
    kt = k_cache.to(f32).permute(0, 2, 3, 1)[:, :, None]
    s = torch.zeros((B, KV, H // KV, C), dtype=f32, device=q.device)
    for d in range(hd):
        s = fma_f32(qg[..., d, None], kt[..., d, :], s)
    s = s * hd ** -0.5
    valid = kept_slots(slot_pos, my_pos, window)
    return torch.where(valid[:, None, None, :], s, NEG)


def decode_gqa_stats_plain(q, k_cache, slot_pos, my_pos, *, window=0):
    """The plain version of :func:`decode_gqa_stats`."""
    B, H, _ = q.shape
    s = _scores_plain(q, k_cache, slot_pos, my_pos, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m).to(torch.float64)).to(torch.float32)
    return (m.reshape(B, H), p.to(torch.float64).sum(dim=-1).reshape(B, H),
            s.reshape(B, H, -1))


def decode_gqa_merge_plain(pmax, psum):
    """The plain version of :func:`decode_gqa_merge` on stacked ``(nb, ...)``
    maxima and sums."""
    m = pmax.amax(dim=0)
    l = torch.zeros_like(psum[0])
    for b in range(pmax.shape[0]):
        l = l + psum[b] * torch.exp(pmax[b].to(torch.float64)
                                    - m.to(torch.float64))
    return m, l.to(torch.float32)


def decode_gqa_pv_plain(s, v_cache, m, l):
    """The plain version of :func:`decode_gqa_pv` (the PV product as an
    einsum: only its summation order differs from the kernel's)."""
    B, H, C = s.shape
    KV = v_cache.shape[2]
    sg = s.reshape(B, KV, H // KV, C)
    mm = m.reshape(B, KV, H // KV, 1)
    ll = l.reshape(B, KV, H // KV, 1)
    p = torch.exp((sg - mm).to(torch.float64)).to(torch.float32)
    p = (p / ll).to(v_cache.dtype).to(torch.float32)
    o = torch.einsum("bkgc,bckh->bkgh", p, v_cache.to(torch.float32))
    return o.reshape(B, H, -1)


def slice_work(B: int, H: int, KV: int, hd: int, C: int, dtype, *,
               pv: bool, n_valid: int | None = None) -> _cost.Work:
    """One slice entry.  Stats: q, the positions and the kept k rows read
    once, the stats (12 bytes per (row, head)) and the kept scores written;
    2 * H * hd flops per kept pair.  PV: the scores, the merged stats and
    the kept v rows read once, the PV sums written; 2 * H * hd flops per
    kept pair."""
    n_valid = B * C if n_valid is None else n_valid
    es = dtype.itemsize
    rows = n_valid * KV * hd * es
    if pv:
        nbytes = 4 * B * H * C + 8 * B * H + rows + 4 * B * H * hd
    else:
        nbytes = (B * H * hd * es + 4 * B * (C + 1) + rows + 12 * B * H
                  + 4 * B * H * C)
    return _cost.Work(bytes=nbytes, ops=2.0 * H * hd * n_valid, dot=True)


def merge_work(nb: int, n: int) -> _cost.Work:
    """One merge: ``nb`` blocks' maxima (f32) and sums (f64) read, ``m`` and
    ``l`` written; ~4 operations per block and (row, head)."""
    return _cost.Work(bytes=12 * nb * n + 8 * n, ops=4.0 * nb * n)


def _stats_call_work(q, k_cache, slot_pos, my_pos, *, result, window=0):
    B, H, hd = q.shape
    n_valid = (None if q.device.type == "meta"
               else int(kept_slots(slot_pos, my_pos, window).sum()))
    return slice_work(B, H, k_cache.shape[2], hd, k_cache.shape[1], q.dtype,
                      pv=False, n_valid=n_valid)


def _pv_call_work(s, v_cache, m, l, *, result):
    B, H, C = s.shape
    # a kept slot's score is finite in every head; head 0 gives the mask
    n_valid = (None if s.device.type == "meta"
               else int((s[:, 0] > NEG).sum()))
    return slice_work(B, H, v_cache.shape[2], v_cache.shape[3], C,
                      v_cache.dtype, pv=True, n_valid=n_valid)


_SLICE_FN = {}
#: ``struct StatsArgs`` / ``struct PVArgs`` of ``csrc/decode_gqa.cu``, packed
#: in one ``struct.pack`` (a pointer to them is the entry's one argument)
_STATS_ARGS = struct.Struct("10P9if")
_PV_ARGS = struct.Struct("6P8i")
_SLICE_ARGTYPES = {
    "decode_gqa_stats_launch": [ctypes.c_char_p, ctypes.c_void_p],
    "decode_gqa_merge_launch": [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_long, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p],
    "decode_gqa_pv_launch": [ctypes.c_char_p, ctypes.c_void_p],
}


def _slice_entry(name: str):
    """Entry ``name`` of the built library, bound once (the packed argument
    layouts checked against the library's)."""
    fn = _SLICE_FN.get(name)
    if fn is None:
        lib = _build.load("decode_gqa")
        size = lib.decode_gqa_slice_args_size
        size.argtypes, size.restype = [ctypes.c_int], ctypes.c_int
        if (size(0), size(1)) != (_STATS_ARGS.size, _PV_ARGS.size):
            raise RuntimeError("decode_gqa: StatsArgs / PVArgs layouts differ "
                               "between csrc/decode_gqa.cu and this wrapper")
        fn = getattr(lib, name)
        fn.argtypes = _SLICE_ARGTYPES[name]
        fn.restype = ctypes.c_int
        _SLICE_FN[name] = fn
    return fn


def _card_limits(device, hd: int, G: int, C: int) -> None:
    """The card's checks of a slice entry."""
    if device.type != "cuda":
        raise ValueError(f"decode_gqa: unsupported device {device}")
    if hd > MAX_HEAD_DIM or G > MAX_GROUP:
        raise ValueError(f"decode_gqa: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM} and G <= {MAX_GROUP}")
    if C == 0:
        raise ValueError("decode_gqa: an empty cache slice")


def _dense(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype``, copied only when it is
    not one already."""
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


@_cost.counted("decode_gqa_stats", _stats_call_work)
def decode_gqa_stats(q: torch.Tensor, k_cache: torch.Tensor,
                     slot_pos: torch.Tensor, my_pos: torch.Tensor, *,
                     window: int = 0):
    """One block's slice of the cache (``slot_pos`` its slots' positions):
    ``(pmax (B, H) f32, psum (B, H) f64, s (B, H, C) f32)``, each (row,
    head)'s max score, the f64 sum of ``exp(s - max)`` (each term rounded
    to f32) and the slice's masked scores, kept for :func:`decode_gqa_pv`.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one workspace allocation: the three results are views of
    it)."""
    global stats_launches
    _check(q, k_cache, k_cache, slot_pos, my_pos)
    if q.device.type == "cpu":
        return decode_gqa_stats_plain(q, k_cache, slot_pos, my_pos,
                                      window=window)
    B, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    _card_limits(q.device, hd, H // KV, C)
    _build.no_grad_inputs("decode_gqa", q, k_cache)
    q, k_cache = _dense(q), _dense(k_cache)
    slot_pos, my_pos = _dense(slot_pos, torch.int32), _dense(my_pos,
                                                             torch.int32)
    nsplit, chunk = split_plan(B, KV, C, _sm_count(q.device))
    # f64: psum, then each chunk's sum; f32 after them: pmax, the scores,
    # each chunk's max, then an int32 count per (row, kv head) (the chunk
    # parts are empty without a split)
    n = B * H
    ns = nsplit if nsplit > 1 else 0
    n64 = n + n * ns
    n32 = n + n * C + n * ns + (B * KV if ns else 0)
    buf = torch.empty(n64 + (n32 + 1) // 2, dtype=torch.float64,
                      device=q.device)
    f32 = buf.view(torch.float32)
    base, o32 = buf.data_ptr(), 2 * n64
    err = _slice_entry("decode_gqa_stats_launch")(_STATS_ARGS.pack(
        q.data_ptr(), k_cache.data_ptr(), slot_pos.data_ptr(),
        my_pos.data_ptr(), base + 4 * (o32 + n), base + 4 * (o32 + n + n * C),
        base + 8 * n, base + 4 * (o32 + n + n * C + n * ns), base + 4 * o32,
        base, B, C, H, KV, hd, int(window),
        1 if q.dtype == torch.bfloat16 else 0, nsplit, chunk, hd ** -0.5),
        _build.stream_handle(q.device))
    _build.check(err, "decode_gqa_stats")
    stats_launches += 1
    return (f32.as_strided((B, H), (H, 1), o32),
            buf.as_strided((B, H), (H, 1), 0),
            f32.as_strided((B, H, C), (H * C, C, 1), o32 + n))


@_cost.counted("decode_gqa_merge",
               lambda pmax, psum, *, result: merge_work(
                   pmax.shape[0], pmax[0].numel()))
def decode_gqa_merge(pmax: torch.Tensor, psum: torch.Tensor):
    """The blocks' stats, stacked ``(nb, ...)`` in block order (f32 maxima,
    f64 sums) -> ``(m, l)`` f32: the max of the maxima and ``l = sum_b
    psum_b * exp(pmax_b - m)`` in f64, in block order.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    global merge_launches
    if pmax.dtype != torch.float32 or psum.dtype != torch.float64 or \
            pmax.shape != psum.shape:
        raise TypeError("decode_gqa_merge takes stacked f32 maxima and f64 "
                        "sums of one shape")
    if pmax.device.type == "cpu":
        return decode_gqa_merge_plain(pmax, psum)
    if pmax.device.type != "cuda":
        raise ValueError(f"decode_gqa_merge: unsupported device "
                         f"{pmax.device}")
    pmax, psum = pmax.contiguous(), psum.contiguous()
    m = torch.empty(pmax.shape[1:], dtype=torch.float32, device=pmax.device)
    l = torch.empty_like(m)
    err = _slice_entry("decode_gqa_merge_launch")(
        pmax.data_ptr(), psum.data_ptr(), pmax.shape[0], m.numel(),
        m.data_ptr(), l.data_ptr(), _build.stream_handle(pmax.device))
    _build.check(err, "decode_gqa_merge")
    merge_launches += 1
    return m, l


@_cost.counted("decode_gqa_pv", _pv_call_work)
def decode_gqa_pv(s: torch.Tensor, v_cache: torch.Tensor, m: torch.Tensor,
                  l: torch.Tensor) -> torch.Tensor:
    """One block's slice from its kept scores ``s`` (``(B, H, C)`` f32, the
    third result of :func:`decode_gqa_stats`): ``(B, H, hd)`` f32 PV sums
    with ``p = exp(s - m) / l`` rounded to the cache's dtype (``m``, ``l``
    the merged ``(B, H)`` stats).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    global pv_launches
    if s.dim() != 3 or v_cache.dim() != 4:
        raise ValueError("decode_gqa_pv: scores (B, H, C), cache "
                         "(B, C, KV, hd)")
    B, H, C = s.shape
    KV, hd = v_cache.shape[2], v_cache.shape[3]
    if (v_cache.shape[:2] != (B, C) or H % KV or m.shape != (B, H)
            or l.shape != (B, H)):
        raise ValueError(
            f"decode_gqa_pv: scores {tuple(s.shape)}, cache "
            f"{tuple(v_cache.shape)}, m {tuple(m.shape)}, l "
            f"{tuple(l.shape)}")
    if s.dtype != torch.float32 or v_cache.dtype not in (torch.float32,
                                                         torch.bfloat16):
        raise TypeError("decode_gqa_pv takes f32 scores and a float32 or "
                        "bfloat16 cache")
    if len({t.device for t in (s, v_cache, m, l)}) != 1:
        raise ValueError("decode_gqa_pv: inputs on different devices")
    if s.device.type == "cpu":
        return decode_gqa_pv_plain(s, v_cache, m, l)
    _card_limits(s.device, hd, H // KV, C)
    _build.no_grad_inputs("decode_gqa", v_cache)
    s, v_cache = _dense(s), _dense(v_cache)
    m, l = _dense(m, torch.float32), _dense(l, torch.float32)
    nsplit, chunk = split_plan(B, KV, C, _sm_count(s.device))
    # the PV sums, then each chunk's (none without a split)
    n = B * H * hd
    buf = torch.empty(n * nsplit + (n if nsplit > 1 else 0),
                      dtype=torch.float32, device=s.device)
    base = buf.data_ptr()
    err = _slice_entry("decode_gqa_pv_launch")(_PV_ARGS.pack(
        s.data_ptr(), v_cache.data_ptr(), m.data_ptr(), l.data_ptr(),
        base + 4 * n, base, B, C, H, KV, hd,
        1 if v_cache.dtype == torch.bfloat16 else 0, nsplit, chunk),
        _build.stream_handle(s.device))
    _build.check(err, "decode_gqa_pv")
    pv_launches += 1
    return buf.as_strided((B, H, hd), (H * hd, hd, 1), 0)
