"""Kernel I's backward, plain version, against the JAX package.

``rglru_scan_bwd_plain`` (the reverse chain ``csrc/rglru_scan_bwd.cu``
runs: ``g = a_{t+1} * g + dh_t``, ``da_t = g_t h_{t-1}``, ``dh0 = a_0
g_0``) against ``jax.vjp`` of ``repro/kernels/ref.py:rglru_scan_ref`` (the
``lax.scan`` oracle of the Pallas kernel), cotangents on both outputs, bit
for bit: XLA on the CPU rounds the transposed step's product and sum
apart (unlike the forward's ``a * h + b``, which it fuses).  Also against
autograd through the port's CPU scan (the model's path, the associative
scan) at 1e-5, the kernel's reverse tile walk (``bwd_tile_plan``, its h
staged one step behind) in numpy against the plain version bit for bit,
and the wrapper's dispatch.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.kernels import ref

from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as RS
from repro_torch.models import rglru as PR


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (B, S, W)).astype(np.float32)
    b = (rng.normal(size=(B, S, W)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    dh = rng.normal(size=(B, S, W)).astype(np.float32)
    dl = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0, dh, dl


@pytest.mark.parametrize("B,S,W", [(2, 37, 16), (1, 64, 33), (3, 5, 8),
                                   (1, 1, 4)])
def test_rglru_bwd_plain_matches_jax_vjp(B, S, W):
    a, b, h0, dh, dl = _inputs(B, S, W, B * 100 + S)
    _, vjp = jax.vjp(ref.rglru_scan_ref, jnp.asarray(a), jnp.asarray(b),
                     jnp.asarray(h0))
    want = vjp((jnp.asarray(dh), jnp.asarray(dl)))
    ta, tb, t0 = (torch.from_numpy(x) for x in (a, b, h0))
    h, _ = RS.rglru_scan_plain(ta, tb, t0)
    # h_last is h[:, -1]: its cotangent joins the last step's
    g = torch.from_numpy(dh).clone()
    g[:, -1] += torch.from_numpy(dl)
    got = RS.rglru_scan_bwd_plain(ta, t0, h, g)
    for x, w in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))


def test_rglru_bwd_plain_matches_autograd_of_the_cpu_scan():
    a, b, h0, dh, _ = _inputs(2, 45, 12, 7)
    ta, tb, t0 = (torch.from_numpy(x).requires_grad_() for x in (a, b, h0))
    PR._scan(ta, tb, t0).backward(torch.from_numpy(dh))
    with torch.no_grad():
        h, _ = RS.rglru_scan_plain(ta, tb, t0)
        got = RS.rglru_scan_bwd_plain(ta, t0, h, torch.from_numpy(dh))
    for x, t in zip(got, (ta, tb, t0)):
        np.testing.assert_allclose(x.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_rglru_bwd_wrapper_takes_the_plain_version_on_the_cpu():
    a, b, h0, dh, _ = (torch.from_numpy(x) for x in _inputs(1, 9, 5, 3))
    h, _ = RS.rglru_scan_plain(a, b, h0)
    before = ops.launch_counts()
    got = ops.rglru_scan_bwd(a, h0, h, dh)
    want = RS.rglru_scan_bwd_plain(a, h0, h, dh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert ops.launch_counts() == before


def _walk_bwd_tiles(a, h0, h, dh):
    """The backward kernel's walk in numpy f32: per lane tile, the step
    tiles of ``bwd_tile_plan`` from the end, each stage holding a, dh and
    h one step behind (h0 before step 0), the chain from the tile's last
    step to its first."""
    B, S, W = a.shape
    f32 = np.float32
    steps, lanes = RS.bwd_tile_plan(S, W)
    da, db = np.empty_like(a), np.empty_like(a)
    dh0 = np.empty_like(h0)
    for row in range(B):
        for w0, w1 in lanes:
            g = np.zeros(w1 - w0, f32)
            a_next = np.zeros(w1 - w0, f32)
            for t0, t1 in steps:
                hp = h[row, max(t0 - 1, 0):t1 - 1, w0:w1]
                if t0 == 0:
                    hp = np.concatenate([h0[row, None, w0:w1], hp])
                for j in range(t1 - t0 - 1, -1, -1):
                    g = (a_next * g).astype(f32) + dh[row, t0 + j, w0:w1]
                    db[row, t0 + j, w0:w1] = g
                    da[row, t0 + j, w0:w1] = g * hp[j]
                    a_next = a[row, t0 + j, w0:w1]
            dh0[row, w0:w1] = a_next * g
    return da, db, dh0


@pytest.mark.parametrize("B,S,W", [(2, 37, 40), (1, 64, 33), (3, 5, 8),
                                   (1, 1, 4), (2, 100, 65)])
def test_bwd_tile_walk_matches_the_plain_version(B, S, W):
    """The reverse tiles cover every step once, last tile (the ragged one)
    first, and walking them as the kernel does gives the plain version's
    bits."""
    a, b, h0, dh, _ = _inputs(B, S, W, S + W)
    steps, lanes = RS.bwd_tile_plan(S, W)
    assert [t for t0, t1 in reversed(steps) for t in range(t0, t1)] == \
        list(range(S))
    assert steps[-1][0] == 0 and all(t1 - t0 <= RS.STEP_TILE
                                     for t0, t1 in steps)
    assert lanes == RS.tile_plan(S, W)[1]
    h, _ = RS.rglru_scan_plain(*(torch.from_numpy(x) for x in (a, b, h0)))
    got = _walk_bwd_tiles(a, h0, h.numpy(), dh)
    want = RS.rglru_scan_bwd_plain(torch.from_numpy(a), torch.from_numpy(h0),
                                   h, torch.from_numpy(dh))
    for x, w in zip(got, want):
        np.testing.assert_array_equal(x, w.numpy())
