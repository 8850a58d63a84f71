"""Activation checkpointing in the port's model stack against the JAX
package's ``_run_stack``.

* The port of ``tests/test_models_smoke.py::
  test_remat_grouping_matches_ungrouped``: glm4-9b at its reduced size with
  4 layers in groups of 2, ``forward`` with and without ``remat`` equal bit
  for bit, and both within 1e-5 of the reference's ``forward(remat=True)``
  from the same parameters.
* The LM loss's gradients through ``forward`` with ``remat`` (each group
  under a checkpoint) bit for bit equal to those of the same layer plan
  run without checkpoints, and to those of ``forward(remat=False)``, for a
  dense config (a group of 4 and a leftover group of 2), the RG-LRU hybrid
  (groups of one period and a remainder block; and a leftover group of two
  periods and a remainder block), an MoE config (the aux loss carried
  through a group) and the encoder-decoder.  A leftover group runs its
  RG-LRU gates as the reference's op-by-op program does, where
  ``remat=False`` scans those periods (``rglru._gates``' ``scanned``), so
  for the hybrid's leftover group ``remat=False`` is another program: there
  the checkpoints are held to the same plan run without them.
* With ``torch.autograd.graph.saved_tensors_hooks``: the bytes an 8-layer
  reduced forward keeps for its backward with ``remat`` are at most half
  of those it keeps without.
* Under ``torch.no_grad()``, or with parameters that need no gradient, no
  checkpoint runs.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as jget
from repro.models import transformer as JT

from repro_torch.configs import get_config
from repro_torch.core import losses
from repro_torch.models import transformer as PT
from repro_torch.train.optimizer import tree_leaves, tree_map


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    n_front = cfg.n_enc_tokens or cfg.n_frontend_tokens
    if n_front:
        out["frontend"] = rng.normal(size=(B, n_front, cfg.d_model)).astype(
            np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _params(cfg, seed=0):
    return PT.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def _reference_params(jcfg, params):
    """The port's parameters in the reference's tree (its leaves in JAX's
    flatten order)."""
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want, treedef = jax.tree.flatten(shapes)
    got = tree_leaves(params)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    return jax.tree.unflatten(treedef, [jnp.asarray(x.numpy()) for x in got])


def test_remat_grouping_matches_ungrouped():
    """remat_every grouping (the reference's §Perf P1-H2) does not change
    the forward."""
    change = dict(n_layers=4, remat_every=2)
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(), **change)
    jcfg = dataclasses.replace(jget("glm4-9b").reduced(), **change)
    params = _params(cfg)
    batch = _batch(cfg)
    with torch.no_grad():
        l_remat, _ = PT.forward(cfg, params, batch, remat=True)
        l_plain, _ = PT.forward(cfg, params, batch, remat=False)
    assert torch.equal(l_remat, l_plain)
    want, _ = jax.jit(lambda p, b: JT.forward(jcfg, p, b, remat=True))(
        _reference_params(jcfg, params),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(l_remat.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _grads(cfg, params, batch, remat: bool):
    """The LM loss's gradients through ``forward`` (``lm_grads``'s loss,
    on one batch): the parameters' gradient tree."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    logits, aux = PT.forward(cfg, live, batch, remat=remat)
    S = batch["tokens"].shape[1]
    loss = (losses.lm_loss(logits[:, -S:], batch["tokens"])
            + cfg.router_aux_weight * aux)
    leaves = tree_leaves(live)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, got)]


# (arch, layers, remat_every, checkpointed groups with remat, whether
# remat=False runs the same arithmetic): a group of 4 and a leftover of 2;
# the hybrid's two groups of one period (rec, rec, attn) and one remainder
# block, then its leftover of two periods and the remainder block; a group
# of 4 MoE layers and a leftover of 1; the encoder-decoder's leftover of 2
# decoder layers
GRAD_CASES = [("qwen1.5-0.5b", 6, 4, 2, True),
              ("recurrentgemma-9b", 7, 1, 2, True),
              ("recurrentgemma-9b", 7, 4, 1, False),
              ("dbrx-132b", 5, 4, 2, True),
              ("seamless-m4t-medium", 2, 4, 1, True)]


@pytest.mark.parametrize("arch,n_layers,every,n_groups,same_plan",
                         GRAD_CASES)
def test_remat_gradients_are_bit_equal(monkeypatch, arch, n_layers, every,
                                       n_groups, same_plan):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers,
                              remat_every=every)
    params = _params(cfg, 1)
    batch = _batch(cfg, seed=1)
    calls = []
    real = PT._checkpoint

    def counted(fn, *args):
        calls.append(fn)
        return real(fn, *args)

    monkeypatch.setattr(PT, "_checkpoint", counted)
    ckpt = _grads(cfg, params, batch, remat=True)
    # the stack's groups, and the CPU path's attention calls on their own
    groups = [f for f in calls if getattr(f, "func", None) is not
              PT.chunked_attention]
    assert len(groups) == n_groups and len(calls) > n_groups
    monkeypatch.setattr(PT, "_checkpoint", lambda fn, *args: fn(*args))
    direct = _grads(cfg, params, batch, remat=True)
    plain = _grads(cfg, params, batch, remat=False)
    for a, b, c in zip(ckpt, direct, plain):
        assert torch.equal(a, b)
        assert torch.equal(a, c) or not same_plan


def _saved_bytes(monkeypatch, cfg, params, batch, remat: bool) -> int:
    """Bytes of the distinct storages other than the parameters that a
    forward keeps for its backward (the checkpoints' own inputs included:
    each group keeps its ``x``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    real = PT._checkpoint

    def keep_inputs(fn, *args):
        for a in args:
            pack(a)
        return real(fn, *args)

    monkeypatch.setattr(PT, "_checkpoint", keep_inputs)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        PT.forward(cfg, live, batch, remat=remat)
    monkeypatch.undo()
    own = {p.untyped_storage().data_ptr() for p in tree_leaves(live)}
    return sum(n for ptr, n in seen.items() if ptr not in own)


def test_remat_keeps_at_most_half_the_saves(monkeypatch):
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=8)
    params = _params(cfg, 2)
    batch = _batch(cfg, 2, 64, seed=2)
    with_remat = _saved_bytes(monkeypatch, cfg, params, batch, True)
    without = _saved_bytes(monkeypatch, cfg, params, batch, False)
    assert 0 < with_remat <= without / 2, (with_remat, without)


def test_no_checkpoint_without_a_gradient(monkeypatch):
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              n_layers=7)
    params = _params(cfg, 3)
    batch = _batch(cfg, seed=3)

    def refuse(*args, **kwargs):
        raise AssertionError("a checkpoint ran without a gradient")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    with torch.no_grad():
        a, _ = PT.forward(cfg, tree_map(lambda p: p.requires_grad_(),
                                        params), batch)
    b, _ = PT.forward(cfg, tree_map(lambda p: p.detach(), params), batch)
    assert torch.equal(a, b)
