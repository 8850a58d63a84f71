"""The port's losses (``repro_torch.core.losses``) against the JAX package's
(``repro.core.losses``): every loss at rtol = atol = 1e-6 on the same
inputs, and its gradient by autograd against the jitted
``jax.value_and_grad`` at the same tolerance (an f32 mean sums in another
order in each framework).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import losses as JL

from repro_torch.core import losses as PL

TOL = dict(rtol=1e-6, atol=1e-6)


def _feats(seed, n_layers=3, B=8, widths=(40, 24, 9)):
    rng = np.random.default_rng(seed)
    f1 = [rng.normal(size=(B, w)).astype(np.float32) for w in widths[:n_layers]]
    f2 = [rng.normal(size=(B, w)).astype(np.float32) for w in widths[:n_layers]]
    diff = (np.arange(B) % 2).astype(np.int32)
    return f1, f2, diff


def _t(xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


def _check_grads(jfn, pfn, f1, f2, diff):
    """Value and the gradients w.r.t. both sides' features."""
    jv, (g1, g2) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        [jnp.asarray(x) for x in f1], [jnp.asarray(x) for x in f2],
        jnp.asarray(diff))
    t1, t2 = _t(f1, True), _t(f2, True)
    pv = pfn(t1, t2, torch.from_numpy(diff))
    pv.backward()
    np.testing.assert_allclose(pv.item(), float(jv), **TOL)
    for t, g in zip(t1 + t2, list(g1) + list(g2)):
        # a layer the loss does not reach: no grad here, zeros in JAX
        tg = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), **TOL)


def test_l1_distance_matches_jax():
    f1, f2, _ = _feats(0)
    np.testing.assert_allclose(
        PL.l1_distance(*_t([f1[0], f2[0]])).numpy(),
        np.asarray(JL.l1_distance(jnp.asarray(f1[0]), jnp.asarray(f2[0]))),
        **TOL)


@pytest.mark.parametrize("margin", [1.0, 0.3])
def test_contrastive_loss_and_grads_match_jax(margin):
    f1, f2, diff = _feats(1, 1)
    _check_grads(lambda a, b, d: JL.contrastive_loss(a[0], b[0], d, margin),
                 lambda a, b, d: PL.contrastive_loss(a[0], b[0], d, margin),
                 f1, f2, diff)


@pytest.mark.parametrize("coeffs", [None, (0.5, 0.3, 0.2), (2.0, 1.0, 1.0)])
def test_layer_aware_loss_and_grads_match_jax(coeffs):
    f1, f2, diff = _feats(2)
    _check_grads(lambda a, b, d: JL.layer_aware_loss(a, b, d, coeffs, 0.8),
                 lambda a, b, d: PL.layer_aware_loss(a, b, d, coeffs, 0.8),
                 f1, f2, diff)


def test_final_layer_contrastive_and_grads_match_jax():
    f1, f2, diff = _feats(3)
    _check_grads(JL.final_layer_contrastive, PL.final_layer_contrastive,
                 f1, f2, diff)


def test_cross_entropy_and_lm_loss_and_grads_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 9, 37)).astype(np.float32) * 3
    toks = rng.integers(0, 37, (2, 9)).astype(np.int32)
    for jfn, pfn, lab in ((JL.cross_entropy, PL.cross_entropy, toks),
                          (JL.lm_loss, PL.lm_loss, toks)):
        jv, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(logits),
                                         jnp.asarray(lab))
        t = torch.from_numpy(logits).requires_grad_()
        pv = pfn(t, torch.from_numpy(lab))
        pv.backward()
        np.testing.assert_allclose(pv.item(), float(jv), **TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)
