"""Kernel E's (``centroid_update``) summation plan on the CPU.

``csrc/centroid_update.cu`` makes one pass over the assigned rows: each
chunk of ``CHUNK_ROWS`` rows is sorted by cluster (row order kept within a
cluster), and the walk keeps one running sum per cluster, folding the open
row block's sum into it where a row crosses into a new block of the
reference's order (``kernels/centroid_update.py:block_end``).
:func:`kernel_walk` takes the same steps in numpy f32 (every add one
rounding), so these tests hold the kernel's order to the plain version and
to the JAX reference (``ops.centroid_update``, the Pallas kernel in
interpret mode) bit for bit.  Where ``B * k`` passes ~8,900 the
reference's own order depends on the CPUs the process may use; there the
walk is held to the plain version bit for bit and to the reference at the
JAX suite's rtol = atol = 1e-5, and ``tests/test_torch_models.py`` pins
those row counts against the reference on one CPU.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro_torch.core._fma import fma_f32
from repro_torch.kernels import centroid_update as CU
from _torch_threads import one_torch_thread  # noqa: F401

SRC = (Path(CU.__file__).parent / "csrc" / "centroid_update.cu").read_text()
#: the largest B * k where the reference's order is one fixed function of
#: its inputs in every CPU set measured (tests/test_torch_models.py)
FIXED_ORDER_BK = 8832


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_match_the_kernel():
    assert _const("E_CHUNK") == CU.CHUNK_ROWS
    assert _const("E_MAX_K") == CU.MAX_K
    assert _const("PART_ROWS") == CU.PART_ROWS
    assert _const("BLOCK_ROWS") == CU.BLOCK_ROWS


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("n_rows", [1, 7, 8, 64, 384, 385, 392, 600, 608,
                                    616, 1000, 1216, 2048, 4096, 5000])
def test_block_end_matches_row_blocks(n_rows, k):
    ends = np.zeros(n_rows, np.int64)
    for start, end in CU.row_blocks(n_rows, k):
        ends[start:min(end, n_rows)] = end
    assert [CU.block_end(r, n_rows, k) for r in range(n_rows)] == list(ends)


def kernel_walk(x: np.ndarray, assign: np.ndarray, k: int) -> np.ndarray:
    """The cluster sums ``(k, d)`` in the kernel's order: per chunk, the
    assigned rows sorted by cluster in row order; per cluster a running sum
    and the open block's sum (f32), folded where a row reaches a new
    block's start."""
    B, d = x.shape
    run_s = np.zeros((k, d), np.float32)
    run_b = np.zeros((k, d), np.float32)
    run_e = np.zeros(k, np.int64)
    for c0 in range(0, B, CU.CHUNK_ROWS):
        rows = np.arange(c0, min(B, c0 + CU.CHUNK_ROWS))
        for j in range(k):
            for r in rows[assign[rows] == j]:
                if r >= run_e[j]:
                    run_s[j] = run_s[j] + run_b[j]
                    run_b[j] = 0
                    run_e[j] = CU.block_end(int(r), B, k)
                run_b[j] = run_b[j] + x[r]
    return run_s + run_b


def _inputs(B, k, F=6):
    """Rows from [0, 100), ignored rows (-1 and >= k) and weight 10, so
    ``w * c`` rounds and the fused multiply-add shows."""
    rng = np.random.default_rng(B * 31 + k)
    c = rng.uniform(0, 100, (k, F)).astype(np.float32)
    x = rng.uniform(0, 100, (B, F)).astype(np.float32)
    a = rng.integers(-1, k + 2, B).astype(np.int32)
    return c, x, a


def _walked(c, x, a, weight):
    k = c.shape[0]
    sums = torch.from_numpy(kernel_walk(x, a, k))
    counts = torch.from_numpy(np.bincount(a[(a >= 0) & (a < k)],
                                          minlength=k).astype(np.float32))
    w = torch.tensor(weight, dtype=torch.float32)
    return (fma_f32(w, torch.from_numpy(c), sums) / (w + counts[:, None])
            ).numpy()


@pytest.mark.parametrize("k", [1, 5, 8, 9, 16])
@pytest.mark.parametrize("B", [64, 392, 600, 1024, 2048])
def test_kernel_walk_matches_plain_and_jax(B, k):
    c, x, a = _inputs(B, k)
    out = _walked(c, x, a, 10.0)
    plain = CU.centroid_update_plain(*map(torch.from_numpy, (c, x, a)),
                                     10.0).numpy()
    np.testing.assert_array_equal(out.view(np.uint32),
                                  plain.view(np.uint32))
    ref = np.asarray(JO.centroid_update(c, x, a, 10.0))
    if B * k <= FIXED_ORDER_BK:
        np.testing.assert_array_equal(out.view(np.uint32),
                                      ref.view(np.uint32))
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,k", [(4500, 5), (4500, 17), (2049, 3)])
def test_kernel_walk_across_chunks_matches_plain(B, k):
    """More rows than one sorted chunk: the running sums carry over."""
    c, x, a = _inputs(B, k)
    plain = CU.centroid_update_plain(*map(torch.from_numpy, (c, x, a)),
                                     10.0).numpy()
    out = _walked(c, x, a, 10.0)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  plain.view(np.uint32))


def test_kernel_walk_with_no_assigned_row_matches_plain():
    c, x, _ = _inputs(64, 5)
    a = np.full(64, -1, np.int32)
    a[::7] = 5                               # >= k: ignored too
    plain = CU.centroid_update_plain(*map(torch.from_numpy, (c, x, a)),
                                     10.0).numpy()
    np.testing.assert_array_equal(_walked(c, x, a, 10.0).view(np.uint32),
                                  plain.view(np.uint32))
