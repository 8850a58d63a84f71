"""AdamW (decoupled weight decay) over the port's parameter trees (port of
:mod:`repro.train.optimizer`).

A tree is nested dicts, tuples and lists of tensors.  Leaves are taken in
JAX's flatten order (dict keys sorted, sequences by index), which is the
order the reference sums the global gradient norm in.

The arithmetic is the reference's compiled program on the CPU
(``jax.jit(adamw_update)``), so on CPU tensors the result is bit-equal:

- each leaf's sum of squares follows XLA's tree reduction
  (:func:`xla_sum`: windows of 32 along every axis of 32 or more, half the
  padding in front, each window summed in one sequential chain, then the
  window sums reduced the same way, a final grid of 2, 4 or 8 rows of at
  most 8 as row chains added by halving), and the leaves' sums are added
  in flatten order;
- XLA rewrites ``(m / bc1) / (sqrt(v / bc2) + eps)`` into ``m / (bc1 *
  (sqrt(v / bc2) + eps))`` and LLVM contracts three multiply-adds into one
  rounding each: ``b1 * m + (1 - b1) * g`` (into ``fma(m, b1, (1 - b1) *
  g)``), ``b2 * v + (1 - b2) * g * g`` (likewise) and ``p - lr * u`` (into
  ``fma(-u, lr, p)``); the port forms those with
  :func:`repro_torch.core._fma.fma_f32` and every other op with its own
  rounding;
- square roots are correctly rounded (:func:`_sqrt`), as XLA's are;
- the bias corrections take the C library's ``powf``, which XLA's CPU
  ``pow`` calls, with a subnormal result flushed to zero as XLA runs.

On a CUDA tensor nothing is compared bit for bit, so the card takes the
same formulas in plain f32 ops (:func:`_leaf_card`): each leaf's sum of
squares is one ``torch.sum`` and no multiply-add or square root is
emulated in f64.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core._fma import fma_f32

_F32 = torch.float32
_WIN = 32


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any                 # f32 first moments, the params' tree
    nu: Any                 # f32 second moments


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _sequential(a: np.ndarray) -> np.ndarray:
    """Sum over the last axis as one f32 chain, left to right."""
    return np.add.accumulate(a, axis=-1, dtype=np.float32)[..., -1]


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of every element of ``x`` in XLA's CPU order (its tree
    reduction rewrite: along each axis of 32 or more, windows of 32 with
    the padding split, half in front; an axis under 32 is one window; a
    window's elements summed in one chain in row-major order; repeated on
    the window sums until every axis is under 32, then one chain, or for a
    grid of 2, 4 or 8 rows of at most 8 its row chains added by halving:
    LLVM's vectorised reduce)."""
    a = x.detach().to(_F32).cpu().numpy()
    windowed = False
    while any(d >= _WIN for d in a.shape):
        windowed = True
        pads, shape = [], []
        for d in a.shape:
            if d >= _WIN:
                n = -(-d // _WIN) * _WIN
                pads.append(((n - d) // 2, n - d - (n - d) // 2))
                shape += [n // _WIN, _WIN]
            else:
                pads.append((0, 0))
                shape += [1, d]
        a = np.pad(a, pads).reshape(shape)
        r = a.ndim // 2
        a = a.transpose(list(range(0, 2 * r, 2)) + list(range(1, 2 * r, 2)))
        a = _sequential(a.reshape(a.shape[:r] + (-1,)))
    a = a.reshape([d for d in a.shape if d != 1])
    if windowed and a.ndim == 2 and a.shape[0] in (2, 4, 8) \
            and a.shape[1] <= 8:
        # LLVM vectorises the reduce of a small window grid across its
        # rows: one lane per row, each a chain, then the lanes added by
        # halving (XLA's optimised IR of a 2 x 2 grid; the other sizes
        # here by their results)
        lanes = _sequential(a)
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = lanes[:h] + lanes[h:]
        return torch.tensor(lanes[0], device=x.device)
    return torch.tensor(_sequential(a.reshape(-1)), device=x.device)


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    sq = g.to(_F32) * g.to(_F32)
    if g.device.type == "cpu":
        return xla_sum(sq)
    return torch.sum(sq)


_POWF = None


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's ``sqrt``): taken in f64
    and rounded once, exact for f32 inputs.  PyTorch's vectorised f32
    ``sqrt`` on the CPU is a fraction of an ulp off in ~0.7 % of values."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def _powf(x: float, y: float) -> np.float32:
    """The C library's ``powf(x, y)`` in f32, a subnormal result flushed to
    zero: what XLA's CPU ``pow`` computes."""
    global _POWF
    if _POWF is None:
        fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
        fn.argtypes = [ctypes.c_float, ctypes.c_float]
        fn.restype = ctypes.c_float
        _POWF = fn
    r = np.float32(_POWF(np.float32(x), np.float32(y)))
    return np.float32(0.0) if abs(r) < np.finfo(np.float32).tiny else r


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                           device=p.device), params)
    leaf = tree_leaves(params)[0]
    return AdamWState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      zeros, tree_map(torch.clone, zeros))


class _Leaf:
    """One leaf's new parameter and moments (a leaf to :func:`tree_map`,
    so not a tuple)."""

    __slots__ = ("p", "m", "v")

    def __init__(self, p, m, v):
        self.p, self.m, self.v = p, m, v


def _leaf_xla(p, g, m, v, scale, bc1, bc2, *, lr, b1, b2, eps,
              weight_decay) -> _Leaf:
    """One leaf's update as XLA's CPU program rounds it (module doc)."""
    f = np.float32
    g = g.to(_F32)
    if scale is not None:
        g = g * scale
    m = fma_f32(m, f(b1), g * f(1.0 - b1))
    v = fma_f32(v, f(b2), g * g * f(1.0 - b2))
    pf = p.to(_F32)
    u = m / (bc1 * (_sqrt(v / bc2) + f(eps)))
    u = fma_f32(pf, f(weight_decay), u)
    return _Leaf(fma_f32(-u, f(lr), pf).to(p.dtype), m, v)


def _leaf_card(p, g, m, v, scale, bc1, bc2, *, lr, b1, b2, eps,
               weight_decay) -> _Leaf:
    """The same formulas in plain f32 ops, for a CUDA leaf."""
    g = g.to(_F32)
    if scale is not None:
        g = g * scale
    m = torch.mul(m, b1).add_(g, alpha=1.0 - b1)
    v = torch.mul(v, b2).addcmul_(g, g, value=1.0 - b2)
    del g
    u = torch.div(v, bc2).sqrt_().add_(eps).mul_(bc1)
    u = torch.div(m, u)
    pf = p.to(_F32)
    u.add_(pf, alpha=weight_decay)
    return _Leaf(torch.sub(pf, u, alpha=lr).to(p.dtype), m, v)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, grad_clip: float = 1.0):
    """``(new params, new state)``: one AdamW step.  ``grads`` has the
    params' tree; the new params keep each parameter's dtype."""
    f = np.float32
    dev = tree_leaves(params)[0].device
    scale = None
    if grad_clip:
        total = None
        for g in tree_leaves(grads):
            s = _sum_of_squares(g)
            total = s if total is None else total + s
        gnorm = _sqrt(total)
        scale = torch.minimum(
            torch.tensor(f(grad_clip), device=dev)
            / torch.maximum(gnorm, torch.tensor(f(1e-9), device=dev)),
            torch.tensor(f(1.0), device=dev))
    t = int(state.step) + 1
    bc1 = torch.tensor(f(1.0) - _powf(b1, t), device=dev)
    bc2 = torch.tensor(f(1.0) - _powf(b2, t), device=dev)
    step = _leaf_xla if dev.type == "cpu" else _leaf_card
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    out = tree_map(lambda p, g, m, v: step(p, g, m, v, scale, bc1, bc2,
                                           **hyper),
                   params, grads, state.mu, state.nu)
    return (tree_map(lambda o: o.p, out),
            AdamWState(state.step + 1, tree_map(lambda o: o.m, out),
                       tree_map(lambda o: o.v, out)))

