"""Griffin-style recurrent block: causal conv1d + RG-LRU gated recurrence
(port of :mod:`repro.models.rglru`).

RG-LRU (Real-Gated Linear Recurrent Unit, arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

:func:`rglru_seq` follows the tensor's device, as every kernel of the port
does: a CUDA tensor launches kernel I (:func:`repro_torch.kernels.ops
.rglru_scan`, the state ``h0`` as its initial carry), a CPU tensor runs a
port of ``jax.lax.associative_scan``'s odd/even recursion with the
reference's combine ``(a1 * a2, a2 * b1 + b2)`` in two roundings, which is
bit-equal to the JAX function on the same ``a, b``.  The two paths differ
by rounding only (kernel I forms ``a * h + b`` with one rounding per step).

The gates follow the reference as the model runs it.  Op by op (the
reference's ``unit_forward``, its unrolled decode, and the layers it runs
outside its layer scan): ``sigmoid(z) = 1 / (exp(-z) + 1)``,
``softplus(x) = max(x, 0) + log1p(exp(-|x|))`` (``jnp.logaddexp(x, 0)``),
``a = exp(log_a)`` and ``1 - a * a`` as written.  Inside the reference's
``lax.scan`` over layers (its prefill, its stacked decode step and the
remat groups of its ``forward``) XLA compiles the block and folds ``a * a
= exp(log_a) * exp(log_a)`` into ``exp(log_a + log_a)``; ``scanned=True``
forms that.  ``a`` sits within 1e-4 of 1 for the slowest lanes, so an ulp
of ``a`` is a large relative change of ``1 - a * a``: the two forms are up
to 1.5e-5 apart after three layers, and both exponentials take XLA's own
``exp`` (:func:`repro_torch.core._fma.xla_exp_f32`), so that they round as
the reference's do.  On the CPU the sigmoids take that ``exp`` too and
``sqrt`` is correctly rounded (taken in f64), as XLA's compiled gates are
(read from ``XLA_FLAGS=--xla_dump_to`` of ``jax.jit(_gates)``: vectorised
``exp`` with fused multiply-adds, ``vsqrtps``); ``softplus``'s ``log1p``
is torch's and differs from XLA's by an ulp for some ``lam``, which the
gates carry without amplification.

Training: on the card the scan runs kernel I under its ``autograd.Function``
with the backward kernel when a gradient is needed
(:mod:`repro_torch.kernels.rglru_scan`); the CPU's associative scan and the
gates are differentiated by autograd (``xla_exp_f32``'s polynomial included).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core._fma import xla_exp_f32
from ..kernels import ops as kops
from .common import draws, scaled_normal, zeros

C_FACTOR = 8.0
_F32 = torch.float32
#: devices that take kernel I; ``meta`` follows the card
_CARD_ROUTE = ("cuda", "meta")


def init_rglru(g: torch.Generator, width: int, dtype,
               n_blocks: int = 1) -> dict:
    """Gate matrices are block-diagonal with ``n_blocks`` ``(w/H, w/H)``
    blocks (Griffin appendix A); ``lam`` is the softplus inverse of
    ``-log(u) / c`` with ``u ~ U(0.9, 0.999)``, so ``a_t`` starts in
    ``(0.9, 0.999)``."""
    dh = width // n_blocks
    dev = g.device
    u = torch.rand((width,), generator=draws(g), device=dev, dtype=_F32)
    u = u * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / C_FACTOR))
    return {
        "wa": scaled_normal(g, (n_blocks, dh, dh), dh ** -0.5, dtype),
        "ba": zeros((width,), _F32, dev),
        "wx": scaled_normal(g, (n_blocks, dh, dh), dh ** -0.5, dtype),
        "bx": zeros((width,), _F32, dev),
        "lam": lam,
    }


def _block_mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., W) through block-diagonal w: (H, dh, dh) -> (..., W)."""
    H, dh, _ = w.shape
    xb = x.reshape(*x.shape[:-1], H, dh)
    yb = torch.einsum("...hd,hde->...he", xb, w)
    return yb.reshape(x.shape)


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    """``1 / (exp(-z) + 1)``; on the CPU with XLA's ``exp``."""
    exp = xla_exp_f32 if z.device.type == "cpu" else torch.exp
    return 1.0 / (exp(-z) + 1.0)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded f32 ``sqrt``, as XLA's ``vsqrtps``: on the CPU
    taken in f64 (PyTorch's vectorised f32 ``sqrt`` there is an ulp off
    for some inputs on AVX-512 hosts), elsewhere as it is."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(x, 0)``."""
    y = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, y)


def _gates(p: dict, x: torch.Tensor, scanned: bool = False):
    """``(a, gated_x)`` in f32; ``scanned`` forms ``a * a`` as
    ``exp(log_a + log_a)``, as the reference's compiled layer scan does."""
    r = _sigmoid(_block_mm(p["wa"], x).to(_F32) + p["ba"])
    i = _sigmoid(_block_mm(p["wx"], x).to(_F32) + p["bx"])
    log_a = (_softplus(p["lam"]) * -C_FACTOR) * r
    a = xla_exp_f32(log_a)
    a2 = xla_exp_f32(log_a + log_a) if scanned else a * a
    gated_x = _sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * x.to(_F32))
    return a, gated_x


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Even and odd elements of axis 1 merged (``len(even)`` is
    ``len(odd)`` or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan`` of the linear-recurrence combine over
    axis 1, in its odd/even recursion (so in its order of roundings)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    reduced = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    odd = associative_scan(*reduced)
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _scan(a: torch.Tensor, b: torch.Tensor,
          h0: Optional[torch.Tensor] = None):
    """``h`` (B, S, W) f32 of ``h_t = a_t h_{t-1} + b_t`` from ``h0`` (or
    zeros), by the device's path."""
    if a.device.type in _CARD_ROUTE:
        if h0 is None:
            h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=_F32,
                             device=a.device)
        h, _ = kops.rglru_scan(a, b, h0)
        return h
    if h0 is not None:
        # fold the incoming state into the first step
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.to(_F32)
    return associative_scan(a, b)[1]


def rglru_seq(p: dict, x: torch.Tensor,
              h0: Optional[torch.Tensor] = None, *, scanned: bool = False):
    """Full-sequence RG-LRU.  x: (B, S, W) -> (y (B, S, W) in ``x``'s
    dtype, h_last (B, W) f32)."""
    a, b = _gates(p, x, scanned)
    h = _scan(a, b, h0)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: dict, x: torch.Tensor, h: torch.Tensor, *,
               scanned: bool = False):
    """One decode step.  x: (B, W), h: (B, W) -> (y, h_new)."""
    a, b = _gates(p, x, scanned)
    h_new = a * h.to(_F32) + b
    return h_new.to(x.dtype), h_new


# --------------------------------------------------------------------------- #
# Causal depthwise conv1d (temporal mixing before the recurrence).
# --------------------------------------------------------------------------- #


def init_conv1d(g: torch.Generator, width: int, kernel: int, dtype) -> dict:
    return {"w": scaled_normal(g, (kernel, width), kernel ** -0.5, dtype),
            "b": zeros((width,), dtype, g.device)}


def conv1d_seq(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv.  x: (B, S, W)."""
    k = p["w"].shape[0]
    S = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:S] * p["w"][0]
    for i in range(1, k):
        out = out + pad[:, i:i + S] * p["w"][i]
    return out + p["b"]


def conv1d_step(p: dict, x: torch.Tensor, buf: torch.Tensor):
    """One decode step with rolling buffer.  x: (B, W), buf: (B, k-1, W)."""
    k = p["w"].shape[0]
    window = torch.cat([buf, x[:, None]], dim=1)             # (B, k, W)
    out = torch.einsum("bkw,kw->bw", window, p["w"]) + p["b"]
    return out, window[:, 1:] if k > 1 else buf
