"""Kernel F (``pairwise_l1``): the port's plain version against the JAX
package's ``ops.pairwise_l1`` (the Pallas kernel in interpret mode on the
CPU), on the same seeded numpy inputs, bit for bit.

The reference sums each ``min(block_d, d)``-column block of ``|x - y|`` in
XLA's window-32 order and adds the block sums in order into a zeroed
output; the port takes the same order, so every entry is equal, including
the zero-padded last block of a ``d`` that spans blocks.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import ops as pops
from repro_torch.kernels import pairwise_l1 as PW
from _torch_threads import one_torch_thread  # noqa: F401

# (B1, B2, d, block_d): the four shapes of test_kernels.py's sweep, its
# odd-size case, two-block and three-block d, the forecaster's first batch
CASES = [(4, 4, 16, 512), (48, 72, 200, 512), (33, 17, 101, 512),
         (128, 16, 64, 512), (37, 23, 101, 64), (33, 17, 1100, 512),
         (9, 5, 513, 512), (16, 16, 6, 512), (1, 7, 6, 512)]


@pytest.mark.parametrize("B1,B2,d,bd", CASES)
def test_plain_matches_jax(B1, B2, d, bd):
    rng = np.random.default_rng(B1 * 1000 + B2 + d)
    x = rng.normal(size=(B1, d)).astype(np.float32)
    y = rng.normal(size=(B2, d)).astype(np.float32)
    want = np.asarray(jops.pairwise_l1(jnp.asarray(x), jnp.asarray(y),
                                       block_b1=16, block_b2=16,
                                       block_d=bd))
    got = pops.pairwise_l1(torch.from_numpy(x), torch.from_numpy(y),
                           block_d=bd)
    assert got.dtype == torch.float32 and got.shape == (B1, B2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_zero_diagonal_symmetry_and_empty():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(12, 40)).astype(np.float32))
    before = PW.launches
    d = PW.pairwise_l1(a, a).numpy()
    assert not d.diagonal().any()
    np.testing.assert_array_equal(d, d.T)
    assert PW.pairwise_l1(a[:0], a).shape == (0, 12)
    assert PW.launches == before               # the CPU never launches


def test_wrapper_checks():
    x = torch.zeros(3, 4)
    with pytest.raises(TypeError):
        PW.pairwise_l1(x.double(), x.double())
    with pytest.raises(ValueError):
        PW.pairwise_l1(x, torch.zeros(3, 5))
    with pytest.raises(ValueError):
        PW.pairwise_l1(x, x, block_d=0)
    assert "pairwise_l1" in pops.launch_counts()
