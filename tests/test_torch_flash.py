"""Kernel G's plain version and the port's attention against the JAX
package.

Inputs are numpy arrays made from a seed and handed to both packages.
``flash_attention_plain`` is held to the JAX kernel (Pallas in interpret
mode, as its own tests run it) at the tolerances of the JAX tests:
rtol 1e-4 / atol 1e-5 in f32 (``test_flash_attention_sweep``) and 3e-2
in bf16 (``test_flash_attention_bf16_inputs``); the two sum each tile's
dot products in another order.  The port's ``chunked_attention``,
``_dense_attention`` and ``decode_attention`` on the CPU are held to the
JAX functions at rtol 1e-5 / atol 1e-6 (f32, another summation order).
The CUDA kernel is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.models import attention as JA

from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ops as PO
from repro_torch.models import attention as PA
from _torch_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(rtol=1e-4, atol=1e-5)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)


def _qkv(B, S, Skv, H, KV, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(dtype) for shape in
                 ((B, S, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 64, 4, 4, 32), (2, 128, 8, 2, 32), (1, 96, 4, 1, 64),
    (2, 64, 16, 16, 16),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_flash_plain_matches_jax_sweep(B, S, H, KV, hd, causal, window):
    """The grid of the JAX ``test_flash_attention_sweep``."""
    q, k, v = _qkv(B, S, S, H, KV, hd, seed=S + H)
    want = np.asarray(JO.flash_attention(q, k, v, causal=causal,
                                         window=window, block_q=32,
                                         block_k=32))
    got = FA.flash_attention_plain(*_t(q, k, v), causal=causal,
                                   window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("S,Skv,causal,window,q_offset", [
    (37, 37, True, 0, 0),        # odd length: ragged q and kv tiles
    (37, 37, True, 5, 0),
    (48, 176, True, 0, 128),     # continued decode: queries after a prefix
    (100, 300, False, 0, 0),     # no mask, S != Skv
    (130, 130, True, 40, 3),
    (256, 256, True, 0, -200),   # rows 0-199 see no key at all
])
def test_flash_plain_odd_offsets_and_dead_rows(S, Skv, causal, window,
                                               q_offset):
    """Odd sizes, ``q_offset`` and rows whose every key is masked (the
    reference then averages ``v`` over its padded key count)."""
    q, k, v = _qkv(1, S, Skv, 4, 2, 16, seed=S + Skv)
    want = np.asarray(JO.flash_attention(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset))
    got = FA.flash_attention_plain(*_t(q, k, v), causal=causal,
                                   window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_plain_bf16_matches_jax():
    """bf16 in, bf16 ``p`` for the PV product, f32 out."""
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, seed=4, dtype=ml_dtypes.bfloat16)
    want = np.asarray(JO.flash_attention(q, k, v, block_q=32, block_k=32))
    tq, tk, tv = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                  for a in (q, k, v))
    got = FA.flash_attention_plain(tq, tk, tv)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)


def test_flash_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = _t(*_qkv(1, 40, 40, 4, 2, 16, seed=1))
    n0 = PO.launch_counts()["flash_attention"]
    out = PO.flash_attention(q, k, v, window=8)
    assert torch.equal(out, FA.flash_attention_plain(q, k, v, window=8))
    assert PO.launch_counts()["flash_attention"] == n0
    with pytest.raises(TypeError):
        PO.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        PO.flash_attention(q, k[:, :, :1].expand(1, 40, 3, 16), v)


@pytest.mark.parametrize("chunk,window", [(32, 0), (64, 0), (32, 16),
                                          (64, 16)])
def test_chunked_attention_matches_jax(chunk, window):
    q, k, v = _qkv(2, 128, 128, 8, 4, 32, seed=21 + chunk + window)
    want = np.asarray(JA.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, chunk=chunk))
    got = PA.chunked_attention(*_t(q, k, v), causal=True, window=window,
                               chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    # the flash kernel's function (the port's path on the card) against the
    # reference's dense oracle; it equals the chunked path only without a
    # window: with one, the reference's chunked path starts each query
    # chunk at the block its LAST row needs (``_block_pairs``), so the
    # first rows of a chunk lose the keys of the block before it
    flash = FA.flash_attention_plain(*_t(q, k, v), window=window)
    oracle = np.asarray(JR.flash_attention_ref(q, k, v, window=window))
    np.testing.assert_allclose(flash.numpy(), oracle, **F32_TOL)
    if not window:
        np.testing.assert_allclose(flash.numpy(), want, **F32_TOL)


def test_dense_attention_matches_jax():
    q, k, v = _qkv(2, 24, 40, 4, 2, 16, seed=7)
    want = np.asarray(JA._dense_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v)))
    got = PA._dense_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    # chunked_attention with no mask takes the dense path in both
    got = PA.chunked_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(11 + window)
    B, H, KV, hd, C = 3, 8, 2, 16, 12
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, C, KV, hd)).astype(np.float32)
    my_pos = np.array([3, 11, 20], np.int32)
    slot_pos = np.where(np.arange(C)[None] <= my_pos[:, None],
                        np.arange(C)[None] + np.maximum(my_pos[:, None] - C
                                                        + 1, 0),
                        -1).astype(np.int32)
    want = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(slot_pos), jnp.asarray(my_pos), window))
    got = PA.decode_attention(*_t(q, kc, vc, slot_pos, my_pos), window)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("dtype,hd,path", [
    (torch.bfloat16, 16, "tensor-core"), (torch.bfloat16, 64, "tensor-core"),
    (torch.bfloat16, 136, "tensor-core"), (torch.bfloat16, 256, "tensor-core"),
    (torch.float32, 20, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 20, None), (torch.bfloat16, 264, None),
    (torch.float32, 264, None)])
def test_flash_kernel_path_follows_the_dtype(dtype, hd, path):
    """On the card bf16 takes the tensor-core kernel and f32 the SIMT one;
    what neither takes (``hd > 256``, bf16 with ``hd % 8``) raises rather
    than falling back."""
    if path is None:
        with pytest.raises(ValueError):
            FA.kernel_path(dtype, hd)
    else:
        assert FA.kernel_path(dtype, hd) == path


@pytest.mark.parametrize("S,chunk,want", [(128, 64, 64), (96, 64, 32),
                                          (37, 1024, 37), (4096, 1024, 1024),
                                          (40, 64, 40), (48, 32, 16)])
def test_chunk_size_divides_the_lengths(S, chunk, want):
    """``chunk_size`` is the chunk :func:`chunked_attention`'s CPU path
    uses: cut to the length and halved until it divides it."""
    got = PA.chunk_size(S, S, chunk)
    assert got == want and S % got == 0
