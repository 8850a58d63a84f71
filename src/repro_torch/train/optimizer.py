"""AdamW (decoupled weight decay) over the port's parameter trees (port of
:mod:`repro.train.optimizer`).

A tree is nested dicts, tuples and lists of tensors.  Leaves are taken in
JAX's flatten order (dict keys sorted, sequences by index), which is the
order the reference sums the global gradient norm in.

The arithmetic is the reference's compiled program on the CPU
(``jax.jit(adamw_update)``), so on CPU tensors the result is bit-equal:

- each leaf's sum of squares follows XLA's CPU program
  (:func:`xla_sum_of_squares`): the tree-reduction rewrite into windows of
  32 where an axis is longer than 32, each window's and then the window
  grid's loop nest as LLVM compiles it (the innermost loop unrolled, the
  loop around it vectorised at the width its cost model picks, lanes
  reduced by halving, a scalar epilogue), the square fused into the nest
  (its adds fused multiply-adds) where no axis is longer than 32; the
  leaves' sums are added in flatten order;
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


def tree_windows(shape) -> list | None:
    """XLA's CPU tree-reduction rewrite of a full reduce over ``shape``
    (``TreeReductionRewriter``, window 32): ``None`` where no axis is
    longer than 32 (the reduce stays one loop nest, the square fused into
    it), else each axis's ``(window, padding in front, padding behind)``:
    an axis longer than 32 takes windows of 32 over its length padded to a
    multiple of 32, half the padding in front; a shorter one is one
    window."""
    if all(d <= _WIN for d in shape):
        return None
    out = []
    for d in shape:
        if d <= _WIN:
            out.append((d, 0, 0))
        else:
            pad = -(-d // _WIN) * _WIN - d
            out.append((_WIN, pad // 2, pad - pad // 2))
    return out


def loop_vf(T: int, F: int, fused: bool) -> int:
    """The vector width LLVM's loop vectoriser gives a reduction loop of
    ``T`` iterations whose body is the (fully unrolled) inner loop of
    ``F`` elements, an interleave group of ``F`` strided loads; 0 where it
    stays scalar.  ``fused``: the body squares each element (the square
    fused into the reduce).  Read from the optimised IR of XLA's CPU
    programs (AVX-512 host, ``prefer-vector-width=256``: 8 f32 lanes at
    most) over T = 2..32, F = 1..32:

    * F = 1 (no inner loop: the loop itself is unrolled) or F > 8 (the
      interleave group costs more than it saves): scalar;
    * T < 16 (LLVM's tiny trip count, no scalar epilogue allowed): one
      vector iteration, VF = T, where T is 2, 4 or 8; else scalar;
    * T >= 16: VF 8 or 4, whichever costs less with the scalar epilogue
      of ``T % VF`` iterations: 8 where ``T % 8 < 4`` (or F = 2 and T >=
      28), else 4; an unfused body of 7 or 8 loads always takes 4.
    """
    if F == 1 or F > 8:
        return 0
    if T < 16:
        return T if T in (2, 4, 8) else 0
    if not fused and F >= 7:
        return 4
    return 8 if T % 8 < 4 or (F == 2 and T >= 28) else 4


def _halving(lanes: torch.Tensor) -> torch.Tensor:
    """``llvm.vector.reduce.fadd`` with ``reassoc`` as x86 lowers it: the
    upper half of the lanes added to the lower half until one is left."""
    while lanes.shape[-1] > 1:
        h = lanes.shape[-1] // 2
        lanes = lanes[..., :h] + lanes[..., h:]
    return lanes[..., 0]


def _nest_sum(a: torch.Tensor, fused: bool, vectorise: bool = True,
              init: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 sum over every axis of ``a`` but the first (a batch of
    independent reductions), as XLA's CPU loop nest over those axes in
    row-major order computes it after LLVM: one scalar accumulator from
    0; the innermost loop fully unrolled; the loop around it vectorised
    at :func:`loop_vf` (lane 0 starts from the accumulator, the others
    from -0; lane l takes iterations i VF + l; then the lanes are reduced
    by halving and the ``T % VF`` remaining iterations follow as scalar
    steps); outer loops carry the scalar.  ``fused``: ``a`` holds the
    unsquared values, a scalar step is one fused multiply-add ``x * x +
    acc`` (LLVM contracts an ``fmul`` whose only use is the ``fadd``) and a
    vector step adds its square by a fused multiply-add where the group
    has at most four members (x86 splits such a group into one load per
    member, so the ``fmul`` feeds the ``fadd`` alone) and the rounded
    square otherwise.  ``vectorise`` False: every loop stays scalar (a
    window nest that bounds-checks padding in its two innermost loops)."""
    dims = [d for d in a.shape[1:] if d != 1]
    a = a.reshape(a.shape[0], *dims)
    acc = torch.zeros(a.shape[0], dtype=_F32) if init is None else init

    def steps(acc, x):  # x: (batch, n) in loop order
        if not fused:
            return torch.from_numpy(_sequential(np.concatenate(
                [acc.numpy()[:, None], x.numpy()], axis=1)))
        for t in range(x.shape[1]):
            acc = fma_f32(x[:, t], x[:, t], acc)
        return acc

    if len(dims) < 2:
        return steps(acc, a.reshape(a.shape[0], -1))
    T, F = dims[-2], dims[-1]
    vf = loop_vf(T, F, fused) if vectorise else 0
    a = a.reshape(a.shape[0], -1, T, F)
    n = T // vf * vf if vf else 0
    for o in range(a.shape[1]):
        blk = a[:, o]
        if vf:
            lanes = torch.full((a.shape[0], vf), -0.0, dtype=_F32)
            lanes[:, 0] = acc
            for i in range(0, n, vf):
                for f in range(F):
                    x = blk[:, i:i + vf, f]
                    if not fused:
                        lanes = lanes + x
                    elif F <= 4:  # x86 splits the group: fmul per member
                        lanes = fma_f32(x, x, lanes)
                    else:
                        lanes = lanes + x * x
            acc = _halving(lanes)
        acc = steps(acc, blk[:, n:].reshape(a.shape[0], -1))
    return acc


def _window_sum(a: torch.Tensor, pads) -> torch.Tensor:
    """Each window's sum (``a``: windows x window dims) as XLA's
    reduce-window loop nest computes it, ``pads`` each window axis's
    padding (in front, behind).  A padded axis bounds-checks its index in
    the loop, which keeps the order but, in one of the two innermost
    loops, also the nest scalar.  Where one of those two loops is padded
    by one element behind only, its check is on its last index alone and
    LLVM unswitches it (the inner one first): the nest over the axis's
    first ``w - 1`` indices runs first, then the last index's slice
    (zeros in the last window) continues the chain, scalar, in row-major
    order."""
    dims = [i for i, d in enumerate(a.shape[1:]) if d != 1]
    cut = next((i for i in reversed(dims[-2:]) if pads[i] == (0, 1)),
               None)
    if cut is not None:
        w = a.shape[1 + cut]
        tail = a.narrow(1 + cut, w - 1, 1)
        a = a.narrow(1 + cut, 0, w - 1)
        pads = [(0, 0) if i == cut else p for i, p in enumerate(pads)]
    inner = [pads[i] != (0, 0) for i in dims][-2:]
    acc = _nest_sum(a, False, vectorise=not any(inner))
    if cut is not None:
        acc = _nest_sum(tail, False, vectorise=False, init=acc)
    return acc


def xla_sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of the squares of ``x``'s elements in the order of
    ``jax.jit(lambda x: jnp.sum(x * x))`` on XLA's CPU backend: where
    :func:`tree_windows` rewrites the reduce, the squares (a kernel of
    their own) are summed per window, then the window grid again (while
    an axis of it is longer than 32), then the grid, each by
    :func:`_nest_sum`; else one loop nest with the square fused in.  The
    vector widths are this CPU's (:func:`loop_vf`)."""
    a = x.detach().to(_F32).cpu()
    shape = tuple(a.shape)
    win = tree_windows(shape)
    if win is None:
        return _nest_sum(a.reshape(1, *shape), True)[0].to(x.device)
    a = a * a
    while win is not None:
        a = torch.nn.functional.pad(
            a, [p for w, lo, hi in reversed(win) for p in (lo, hi)])
        grid = [a.shape[i] // w for i, (w, _, _) in enumerate(win)]
        split = [v for g, (w, _, _) in zip(grid, win) for v in (g, w)]
        r = len(win)
        a = a.reshape(split).permute(list(range(0, 2 * r, 2))
                                     + list(range(1, 2 * r, 2)))
        a = _window_sum(a.reshape(-1, *[w for w, _, _ in win]),
                        [(lo, hi) for _, lo, hi in win]).reshape(grid)
        win = tree_windows(tuple(a.shape))
    return _nest_sum(a.reshape(1, *a.shape), False)[0].to(x.device)


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    if g.device.type == "cpu":
        return xla_sum_of_squares(g)
    sq = g.to(_F32) * g.to(_F32)
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

