"""A correctly rounded f32 fused multiply-add built from PyTorch ops.

XLA on the CPU contracts a few ``a * b + c`` of the reference's step into
one fused multiply-add (one rounding instead of two): the priority terms
``1 - alpha * laxity``, ``1 - beta * utility`` and ``laxity + 1e-9 *
release``, and the capacitor charge ``energy + power * dt``.  The port
forms exactly those with :func:`fma_f32` (``__fmaf_rn`` in the CUDA
kernels) and every other product and sum with two roundings.

The emulation is Boldo & Melquiond's: the product of two f32 values is
exact in f64; the f64 sum with ``z`` is made round-to-odd (a TwoSum error
term, then one step of :func:`torch.nextafter` towards it when the sum is
inexact and its last bit is even); rounding that to f32 is then correct,
because f64 carries more than 24 + 1 bits.  A plain f64 sum and cast would
round twice and be wrong in rare cases (a sum that lands on an f32
midpoint).
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_F64 = torch.float64


def _f64(v):
    """``v`` in f64, rounded to f32 first (python floats are f32 constants
    in the reference, as ``np.float32(v)``); python floats stay scalars."""
    if isinstance(v, torch.Tensor):
        return v.to(_F32).to(_F64)
    return float(np.float32(v))


def fma_f32(x, y, z) -> torch.Tensor:
    """``x * y + z`` rounded once to f32 (round to nearest, ties to even).

    Arguments broadcast; python floats are f32 constants.  At least one of
    ``x``, ``y`` must be a tensor."""
    p = _f64(x) * _f64(y)          # exact: 24 + 24 bits <= 53
    z = _f64(z)
    s = p + z
    # TwoSum: err = (p + z) - s exactly
    bb = s - p
    err = (p - (s - bb)) + (z - bb)
    # round to odd: an inexact sum with an even last bit moves one step
    # towards the exact value
    bump = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    s = torch.where(bump, torch.nextafter(s, err * float("inf")), s)
    return s.to(_F32)
