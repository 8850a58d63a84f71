"""The port's MoE FFN against the JAX package.

``apply_moe``'s output and load-balance loss on the reduced dbrx-132b and
qwen3-moe-235b-a22b (4 experts, top-2, d_model 256, f32), with the
reference's random weights carried over by ``convert.tree``, at rtol =
atol = 1e-5 (the JAX suite's tolerance between two evaluations of one
model).  Each case first asserts that the router chose the same experts
(``expert_idx``) and kept the same (token, slot) pairs (``keep``) as the
reference's router, so a near-tie flip shows as a flip and not as a gap.
The cases: the reduced config (capacity factor 8: nothing drops); a
capacity factor of 1.25 in groups of 64, where tokens drop; the decode form
(one token per slot, the slots one group); and an exact tie in the
router's probabilities, where both take the lower expert index first.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import moe as JM

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe as PM
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("dbrx-132b", "qwen3-moe-235b-a22b")


def _configs(arch, **over):
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _params(jcfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, convert.tree(jax.tree.map(np.asarray, jp), "cpu")


def _jax_route(jp, jcfg, x):
    """The reference's routing, step by step as ``repro.models.moe
    .apply_moe`` takes it: (expert_idx, keep)."""
    B, S, D = x.shape
    E, K = jcfg.n_experts, jcfg.top_k
    G = min(jcfg.moe_group_size, B * S)
    while (B * S) % G:
        G //= 2
    n = (B * S) // G
    C = JM._capacity(G, K, E, jcfg.capacity_factor)
    xg = jnp.asarray(x).reshape(n, G, D)
    logits = jnp.einsum("gtd,de->gte", xg.astype(jnp.float32), jp["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    assign = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    pos = jnp.cumsum(assign.reshape(n, G * K, E), axis=1).reshape(
        n, G, K, E) - assign
    return np.asarray(idx), np.asarray((pos < C) * assign)


def _check(jcfg, pcfg, jp, tp, x):
    idx, keep = _jax_route(jp, jcfg, x)
    G = PM.group_size(pcfg, x.shape[0] * x.shape[1])
    r = PM.route(tp, pcfg, torch.from_numpy(x).reshape(-1, G, x.shape[2]))
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    yj, aj = JM.apply_moe(jp, jcfg, jnp.asarray(x))
    yp, ap = PM.apply_moe(tp, pcfg, torch.from_numpy(x))
    assert yp.dtype == torch.float32 and ap.dtype == torch.float32
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(ap), float(aj), **TOL)
    return r


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_capacity_and_group_size_match_reference():
    for group, k, e, f in ((512, 4, 16, 1.25), (16, 4, 16, 1.25),
                           (512, 8, 128, 1.25), (64, 2, 4, 8.0),
                           (3, 2, 4, 1.25), (1, 8, 128, 1.25)):
        assert PM._capacity(group, k, e, f) == JM._capacity(group, k, e, f)
    # dbrx's decode: the 16 slots are one group, capacity 5
    assert PM._capacity(16, 4, 16, 1.25) == 5
    cfg = get_config("dbrx-132b")
    for n in (4096, 16, 1, 24, 37, 1000):
        G = PM.group_size(cfg, n)
        assert n % G == 0 and G <= 512
    assert PM.group_size(cfg, 1000) == 8 and PM.group_size(cfg, 24) == 24


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch):
    jcfg, pcfg = _configs(arch)
    jp, tp = _params(jcfg)
    r = _check(jcfg, pcfg, jp, tp, _x((2, 64, jcfg.d_model), 0))
    assert torch.equal(r.keep, r.assign)        # capacity 8: nothing drops


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_drops_tokens_as_jax(arch):
    """Capacity 40 per expert in groups of 64 tokens x 2 slots; the tokens
    lean towards expert 0's router column, so it overflows."""
    jcfg, pcfg = _configs(arch, capacity_factor=1.25, moe_group_size=64)
    jp, tp = _params(jcfg, 1)
    r0 = np.asarray(jp["router"])[:, 0]
    x = _x((2, 96, jcfg.d_model), 1) + 0.3 * jcfg.d_model ** 0.5 * (
        r0 / np.linalg.norm(r0)).astype(np.float32)
    r = _check(jcfg, pcfg, jp, tp, x)
    assert r.capacity == 40
    assert float(r.keep.sum()) < float(r.assign.sum())   # tokens dropped


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_decode_form_matches_jax(arch, cf):
    """``block_step``'s call: ``(B, 1, D)``, the B slots one group."""
    jcfg, pcfg = _configs(arch, capacity_factor=cf)
    jp, tp = _params(jcfg, 2)
    _check(jcfg, pcfg, jp, tp, _x((16, 1, jcfg.d_model), 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_tie_takes_the_lower_expert(arch):
    """Experts 1 and 2 share their router column, so every token's
    probabilities tie exactly there; ``lax.top_k`` and the port's stable
    sort both put expert 1 first.  Some tokens rank the pair first and
    second, so the top-2 is the tied pair."""
    jcfg, pcfg = _configs(arch)
    jp, tp = _params(jcfg, 3)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    r = _check(jcfg, pcfg, jp, tp, _x((2, 32, jcfg.d_model), 3))
    probs = r.probs.numpy()
    assert np.array_equal(probs[..., 1], probs[..., 2])
    idx = r.expert_idx.numpy()
    pair = (idx[..., 0] == 1) & (idx[..., 1] == 2)
    assert pair.any() and not ((idx[..., 0] == 2) & (idx[..., 1] == 1)).any()


def test_top_k_matches_lax_on_ties():
    rng = np.random.default_rng(4)
    p = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 5, 16):
        vj, ij = jax.lax.top_k(jnp.asarray(p), k)
        vp, ip = PM.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))


def test_init_moe_layout_and_dtypes():
    """The reference's leaves and shapes; the router stays f32 in a bf16
    model."""
    jcfg, pcfg = _configs("dbrx-132b", dtype="bfloat16")
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    mine = PM.init_moe(torch.Generator().manual_seed(0), pcfg, torch.bfloat16)
    assert set(mine) == set(jp)
    for name, leaf in jp.items():
        assert tuple(mine[name].shape) == leaf.shape, name
        assert str(mine[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert mine["router"].dtype == torch.float32
