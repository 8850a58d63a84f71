"""Kernel I (``rglru_scan``) and the RG-LRU block of the port against the
JAX package.

* The plain version of kernel I against ``repro.kernels.ops.rglru_scan``
  (the Pallas kernel in interpret mode on the CPU) and its oracle
  ``ref.rglru_scan_ref``, bit for bit: both form ``a * h + b`` as one
  fused multiply-add, as the plain version does.
* XLA's ``exp`` as the port emulates it (``core._fma.xla_exp_f32``),
  bit for bit against the jitted ``jnp.exp``.
* ``rglru_seq``'s CPU scan (the port of ``jax.lax.associative_scan``) on
  the reference's own gates, bit for bit against the JAX ``rglru_seq`` at
  odd and even recursion depths, with and without an incoming state.
* ``_gates``, ``rglru_step``, ``conv1d_seq`` and ``conv1d_step`` at
  rtol = atol = 1e-5 (torch's and XLA's transcendentals differ by an ulp
  here and there).
* ``_gates(scanned=True)`` against the jitted JAX ``_gates``, in which XLA
  folds ``a * a`` into ``exp(log_a + log_a)``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops, ref
from repro.models import rglru as JR

from repro_torch import convert
from repro_torch.core._fma import xla_exp_f32
from repro_torch.kernels import rglru_scan as RS
from repro_torch.models import rglru as PR
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _scan_inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (B, S, W)).astype(np.float32)
    b = (rng.normal(size=(B, S, W)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,S,W,blocks", [
    (1, 8, 16, {}), (4, 64, 96, {}), (2, 100, 33, {}), (8, 17, 128, {}),
    (3, 37, 53, dict(block_b=2, block_s=16, block_w=32)),
])
def test_rglru_scan_plain_matches_jax_bit_for_bit(B, S, W, blocks):
    """The JAX sweep's four shapes and its odd shape (every axis padded in
    the reference, the sequence with identity steps), nonzero ``h0``."""
    a, b, h0 = _scan_inputs(B, S, W, seed=B * S)
    h, hl = ops.rglru_scan(a, b, h0, **blocks)
    rh, rhl = ref.rglru_scan_ref(a, b, h0)
    before = RS.launches
    ph, phl = RS.rglru_scan(*map(torch.from_numpy, (a, b, h0)))
    assert RS.launches == before               # the CPU never launches
    for got, want in ((ph, h), (phl, hl), (ph, rh), (phl, rhl)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_xla_exp_matches_jitted_jnp_exp():
    rng = np.random.default_rng(1)
    exp = jax.jit(jnp.exp)
    for lo, hi in ((-0.3, 0.0), (-3.0, 3.0), (-90.0, 90.0)):
        x = rng.uniform(lo, hi, 3_000_000).astype(np.float32)
        got = xla_exp_f32(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(exp(x)).view(np.int32))
    edge = np.array([-87.9, -87.5, -87.0, -100.0, 0.0, 1e-8, -1e-8, 88.7,
                     89.0, np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(
        xla_exp_f32(torch.from_numpy(edge)).numpy(), np.asarray(exp(edge)))


@pytest.fixture(scope="module")
def block():
    W = 64
    p = JR.init_rglru(jax.random.PRNGKey(0), W, jnp.float32, n_blocks=4)
    cp = JR.init_conv1d(jax.random.PRNGKey(3), W, 4, jnp.float32)
    tree = lambda t: convert.tree(jax.tree.map(np.asarray, t), "cpu")
    return W, p, tree(p), cp, tree(cp)


@pytest.mark.parametrize("S", [1, 2, 3, 100, 257])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_seq_scan_matches_jax_on_its_gates(block, S, with_h0):
    """The CPU path of ``rglru_seq`` runs the reference's associative scan
    in its own order of roundings: on the reference's ``a, b`` the states
    are bit-equal at odd and even recursion depths."""
    W, p, _, _, _ = block
    rng = np.random.default_rng(S)
    x = jnp.asarray((rng.normal(size=(2, S, W)) * 0.5).astype(np.float32))
    h0 = rng.normal(size=(2, W)).astype(np.float32) if with_h0 else None
    a, b = JR._gates(p, x)
    want_y, want_h = JR.rglru_seq(p, x, None if h0 is None
                                  else jnp.asarray(h0))
    got = PR._scan(torch.from_numpy(np.array(a)),
                   torch.from_numpy(np.array(b)),
                   None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want_y).view(np.int32))
    np.testing.assert_array_equal(got[:, -1].numpy(), np.asarray(want_h))


def test_gates_step_and_conv_match_jax(block):
    W, p, tp, cp, tcp = block
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 100, W)) * 0.5).astype(np.float32)
    a, b = JR._gates(p, jnp.asarray(x))
    pa, pb = PR._gates(tp, torch.from_numpy(x))
    np.testing.assert_allclose(pa.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(pb.numpy(), np.asarray(b), **TOL)
    y, hl = JR.rglru_seq(p, jnp.asarray(x))
    py, phl = PR.rglru_seq(tp, torch.from_numpy(x))
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(phl.numpy(), np.asarray(hl), **TOL)

    xs = rng.normal(size=(2, W)).astype(np.float32)
    hs = rng.normal(size=(2, W)).astype(np.float32)
    yj, hj = JR.rglru_step(p, jnp.asarray(xs), jnp.asarray(hs))
    yp, hp = PR.rglru_step(tp, torch.from_numpy(xs), torch.from_numpy(hs))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)

    np.testing.assert_allclose(
        PR.conv1d_seq(tcp, torch.from_numpy(x)).numpy(),
        np.asarray(JR.conv1d_seq(cp, jnp.asarray(x))), **TOL)
    buf = rng.normal(size=(2, 3, W)).astype(np.float32)
    oj, bj = JR.conv1d_step(cp, jnp.asarray(xs), jnp.asarray(buf))
    op, bp = PR.conv1d_step(tcp, torch.from_numpy(xs), torch.from_numpy(buf))
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))


def test_scanned_gates_follow_jitted_jax(block):
    """Each form of ``1 - a * a`` agrees with its own reference program
    (most ``gated_x`` bit for bit, the rest an ulp of a transcendental
    apart) and not with the other: the jitted reference folds ``a * a``."""
    W, p, tp, _, _ = block
    x = (np.random.default_rng(7).normal(size=(2, 100, W)) * 0.5).astype(
        np.float32)
    jit_b = np.asarray(jax.jit(JR._gates)(p, jnp.asarray(x))[1])
    eager_b = np.asarray(JR._gates(p, jnp.asarray(x))[1])
    scan_a, scan_b = PR._gates(tp, torch.from_numpy(x), scanned=True)
    op_b = PR._gates(tp, torch.from_numpy(x))[1].numpy()
    np.testing.assert_allclose(scan_b.numpy(), jit_b, **TOL)
    assert np.mean(scan_b.numpy() == jit_b) > 0.9
    assert np.mean(op_b == eager_b) > 0.9
    assert np.mean(op_b == jit_b) < 0.6
    assert np.mean(scan_b.numpy() == eager_b) < 0.6


def test_init_rglru_layout_and_range():
    g = torch.Generator().manual_seed(0)
    p = PR.init_rglru(g, 64, torch.bfloat16, n_blocks=4)
    ref_p = JR.init_rglru(jax.random.PRNGKey(0), 64, jnp.bfloat16,
                          n_blocks=4)
    for k, v in ref_p.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[-1] == str(v.dtype), k
    # a = exp(-c softplus(lam)) at r = 1 lies in (0.9, 0.999)
    a = torch.exp(-PR.C_FACTOR * torch.nn.functional.softplus(p["lam"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())


def test_rglru_scan_wrapper_rejects_bad_inputs():
    a = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError):
        RS.rglru_scan(a, torch.zeros(2, 5, 7), torch.zeros(2, 8))
    with pytest.raises(ValueError):
        RS.rglru_scan(a, a, torch.zeros(2, 7))
