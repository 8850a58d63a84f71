"""Shared building blocks: norms, activations, RoPE, initializers (port of
:mod:`repro.models.common`).

:func:`sanitize_dim` is the reference's rule for dropping the mesh axes a
dimension does not divide (:mod:`repro_torch.launch.sharding` infers its
specs with it).  The reference's in-model sharding constraints (``shard``,
``logical_axis_rules``) split one model over several cards and have no
counterpart yet.  Initializers draw from an explicit
:class:`torch.Generator`; their distributions and scales are the
reference's, their numbers are not (the tests carry the reference's weights
over with :func:`repro_torch.convert.transformer_params`).  A
:class:`ShapeOnly` generator draws nothing: its trees live on the ``meta``
device, with the shapes and dtypes of the real ones.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

_F32 = torch.float32

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def sanitize_dim(axes, dim: int, axis_sizes: Mapping[str, int]):
    """Drop the mesh axes a dim is not divisible by (e.g. 2 KV heads on a
    16-way model axis fall back to replication).  Axes are kept greedily in
    order, each while the product of those kept so far still divides
    ``dim``; an axis the sizes do not name counts as size 1."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    total, kept = 1, []
    for a in axes:
        sz = axis_sizes.get(a, 1)
        if dim % (total * sz) == 0:
            kept.append(a)
            total *= sz
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


# --------------------------------------------------------------------------- #
# Initializers (parameters stored in the config's dtype).
# --------------------------------------------------------------------------- #


class ShapeOnly:
    """A generator stand-in that draws nothing: initializers given it make
    tensors on the ``meta`` device (a ``torch.Generator`` cannot live
    there), so a whole-size parameter tree costs no memory."""

    device = torch.device("meta")


def draws(generator):
    """``generator`` as the ``generator=`` of a ``torch`` random call:
    ``None`` for a :class:`ShapeOnly` one (meta tensors hold no values)."""
    return None if isinstance(generator, ShapeOnly) else generator


def _normal(shape, generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=draws(generator),
                       device=generator.device, dtype=_F32)


def dense_init(generator, in_dim: int, out_shape: Sequence[int],
               dtype) -> torch.Tensor:
    scale = in_dim ** -0.5
    return (_normal((in_dim, *out_shape), generator) * scale).to(dtype)


def embed_init(generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (_normal((vocab, d), generator) * 0.02).to(dtype)


def scaled_normal(generator, shape, scale: float, dtype) -> torch.Tensor:
    return (_normal(shape, generator) * scale).to(dtype)


def zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape, dtype, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# Norms and activations.
# --------------------------------------------------------------------------- #


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(_F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(_F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * scale + bias


def norm_init(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": ones((d,), dtype, device)}
    return {"scale": ones((d,), dtype, device),
            "bias": zeros((d,), dtype, device)}


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def activate(kind: str, x: torch.Tensor) -> torch.Tensor:
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default."""
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    if kind == "silu":
        return F.silu(x)
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# Rotary position embeddings.
# --------------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=_F32, device=device) / head_dim
    # a python base: no host-to-device copy (f32 pow, as the reference's)
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Computed in
    f32 and cast back to ``x``'s dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].to(_F32) * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                           # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., : hd // 2].to(_F32)
    x2 = x[..., hd // 2:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
