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



# XLA's f32 ``exp`` on the CPU: Cephes' ``expf`` (x = n ln2 + r with a
# two-part ln2, a degree-5 polynomial in r, scaled by 2^n), every
# multiply-add of it fused as LLVM fuses it there, subnormal results
# flushed to zero as the CPU runs it
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_F32_TINY = float(np.finfo(np.float32).tiny)
_LOG2E = 1.4426950216293335
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022,
          0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
          0.5)


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` for an f32 tensor with the reference's rounding.

    Each fused multiply-add is formed in f64 (the product of two f32
    values is exact there) and rounded to f32: a double rounding, which
    differs from one fused rounding only when the f64 sum lands on an f32
    midpoint (about one case in 2^29).  Bit-equal to the jitted
    ``jnp.exp`` of the reference on 9 M values in [-90, 90]
    (``tests/test_torch_rglru.py``); about 40 operations, against some 170
    with :func:`fma_f32` throughout."""
    x = torch.clamp(x.to(_F32), _EXP_LO, _EXP_HI).to(_F64)
    n = torch.clamp(torch.floor((x * _LOG2E + 0.5).to(_F32)), -127.0,
                    127.0)
    n64 = n.to(_F64)
    r = (n64 * -_LN2_HI + x).to(_F32).to(_F64)
    r = (n64 * -_LN2_LO + r).to(_F32).to(_F64)
    y = (r * _EXP_P[0] + _EXP_P[1]).to(_F32)
    for c in _EXP_P[2:]:
        y = (y.to(_F64) * r + c).to(_F32)
    r2 = (r * r).to(_F32).to(_F64)
    y = (y.to(_F64) * r2 + r).to(_F32) + 1.0
    # 2^n from its exponent bits; n = -127 gives the bits of 0.0
    out = y * ((n.to(torch.int32) + 127) << 23).view(_F32)
    return torch.where(out < _F32_TINY, 0.0, out)
