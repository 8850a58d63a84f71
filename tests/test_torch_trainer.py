"""The port's trainer against the JAX package.

* ``train_step_lm`` for every assigned architecture at its ``reduced()``
  size against ``jax.jit(make_train_step(cfg))`` from the same parameters
  (the port's initialisation, carried into the reference's tree) and the
  reference's optimizer state carried over by ``convert``: loss, aux
  and total at rtol = atol = 1e-5.  The gradients are compared through the
  first moments the step writes (from a zero state ``mu = 0.1 * g`` after
  clipping, so a moment's gap is its gradient's gap x 0.1): every leaf
  within 2e-5 of that leaf's largest value, or of 1e-3 of the model's
  largest if that is more (a leaf under it is rounding noise: the sLSTM's
  input-gate bias has a gradient that cancels exactly, and JAX's own
  jitted and op-by-op gradients of it differ by more than either).  The
  new parameters: within 1e-2 * lr, plus what that gradient tolerance can
  move a first Adam step, ``u = g / (|g| + eps)``, by (``lr * delta * eps /
  (|g| + eps)^2``: a gradient near ``eps = 1e-8`` magnifies its rounding).
* ``microbatches=2`` against 1 in the port (the reference's own test of
  its scan).
* The agile CNN's ``siamese_step`` (both pair losses) and ``ce_step``,
  five steps from the reference's initial parameters against the
  reference's step (its ``train_agile_cnn`` inner step, jitted) on a
  narrowed MNIST CNN: each loss at rtol 1e-5; of each parameter leaf
  (conv weights compared in the reference's HWIO) 99.9 % of the elements
  within 1e-2 * lr per step taken and all within 2 * lr per step (a ReLU
  at zero or a max-pool tie routes a gradient differently in the two
  frameworks).
* ``train_agile_cnn`` end to end on the conftest's ``mnist_tiny`` (the
  narrowed CNN): the history falls and the bank has one calibrated
  classifier per unit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jget
from repro.core import losses as JL
from repro.models import cnn as JC
from repro.models import transformer as JT
from repro.train import adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train import make_train_step as j_make_train_step

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import make_siamese_pairs
from repro_torch.models import cnn as PC
from repro_torch.models import transformer as PT
from repro_torch.train import adamw_init, train_agile_cnn, train_step_lm
from repro_torch.train import trainer as TR
from repro_torch.train.optimizer import tree_leaves

LR = 3e-4
EPS = 1e-8


def _batch(cfg, B=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    n_front = cfg.n_enc_tokens or cfg.n_frontend_tokens
    if n_front:
        out["frontend"] = rng.normal(size=(B, n_front, cfg.d_model)).astype(
            np.float32)
    return out


def _reference_params(jcfg, params):
    """The port's f32 parameter tree as the reference's: the leaves in
    JAX's flatten order (the port's ``tree_leaves`` order) into the tree
    the reference's ``init_params`` builds, traced but not run (the
    reference's eager initialisation costs seconds per config here)."""
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want, treedef = jax.tree.flatten(shapes)
    got = tree_leaves(params)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    return jax.tree.unflatten(treedef, [jnp.asarray(x.numpy()) for x in got])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_lm_train_step_matches_jax(arch):
    jcfg, pcfg = jget(arch).reduced(), get_config(arch).reduced()
    params = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jp = _reference_params(jcfg, params)
    jo = j_adamw_init(jp)
    batch = _batch(jcfg)
    new_j, opt_j, m_j = jax.jit(j_make_train_step(jcfg, lr=LR))(
        jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    new_p, opt_p, m_p = train_step_lm(
        pcfg, params, convert.adamw_state(jax.tree.map(np.asarray, jo), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, lr=LR)
    for key in ("loss", "aux", "total"):
        np.testing.assert_allclose(float(m_p[key]), float(m_j[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert int(opt_p.step) == 1
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(opt_j.mu)[0]]
    mu_j = [np.asarray(x, np.float32) for x in jax.tree.leaves(opt_j.mu)]
    mu_p = [x.numpy() for x in tree_leaves(opt_p.mu)]
    assert len(mu_p) == len(mu_j)
    top = max(np.abs(m).max() for m in mu_j)
    for path, a, b, pn, jn in zip(paths, mu_p, mu_j, tree_leaves(new_p),
                                  jax.tree.leaves(new_j)):
        delta = 2e-5 * max(np.abs(b).max(), 1e-3 * top)
        gap = np.abs(a - b).max()
        assert gap <= delta, (arch, path, gap, delta)
        # the gradient after clipping, and the update's sensitivity to it
        g = np.abs(b) / 0.1
        dg = delta / 0.1
        room = LR * (1e-2 + np.minimum(
            2.0, dg * EPS / (np.maximum(g - dg, 0.0) + EPS) ** 2))
        got = pn.float().numpy()
        want = np.asarray(jn, np.float32)
        assert np.all(np.abs(got - want) <= room), (arch, path)


def test_microbatched_lm_step_matches_one_batch():
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = PT.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 8, 3).items()}
    p1, o1, m1 = train_step_lm(cfg, params, adamw_init(params), batch,
                               microbatches=1)
    p2, o2, m2 = train_step_lm(cfg, params, adamw_init(params), batch,
                               microbatches=2)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["total"]) == pytest.approx(float(m2["total"]), rel=1e-5)
    for a, b in zip(tree_leaves(o1.mu), tree_leaves(o2.mu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()) + 1e-12)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-3)


# --------------------------------------------------------------------------- #
# The agile CNN.
# --------------------------------------------------------------------------- #

NARROW = dict(name="mnist", input_shape=(28, 28, 1),
              convs=((6, 5, True), (12, 5, True)), fcs=(32, 24), n_classes=10)
CNN_LR = 1e-3


def _jax_siamese_step(cfg, loss_fn):
    """The reference's inner step of ``train_agile_cnn`` (siamese arm)."""

    @jax.jit
    def step(params, opt, a, b, d):
        def fn(params):
            fa = JC.cnn_forward_all(cfg, params, a)
            fb = JC.cnn_forward_all(cfg, params, b)
            fa = [f / (jnp.abs(f).mean() + 1e-6) for f in fa]
            fb = [f / (jnp.abs(f).mean() + 1e-6) for f in fb]
            return loss_fn(fa, fb, d)

        l, g = jax.value_and_grad(fn)(params)
        params, opt = j_adamw_update(params, g, opt, lr=CNN_LR)
        return params, opt, l

    return step


def _jax_ce_step(cfg):
    """The reference's inner step of ``train_agile_cnn`` (CE arm)."""

    @jax.jit
    def step(full, opt, x, y):
        def fn(full):
            feats = JC.cnn_forward_all(cfg, full["net"], x)
            logits = feats[-1] @ full["head"]["w"] + full["head"]["b"]
            return JL.cross_entropy(logits, y)

        l, g = jax.value_and_grad(fn)(full)
        full, opt = j_adamw_update(full, g, opt, lr=CNN_LR)
        return full, opt, l

    return step


def _assert_cnn_close(port_params, jax_params, steps):
    """Every leaf: at least 99.9 % of its elements within 1e-2 * lr per
    step taken, and all within the 2 * lr per step an Adam step can move
    one.  A ReLU output at zero in one framework and an ulp above it in
    the other, or a max-pool tie, routes a gradient differently; its
    element then takes another Adam step (one conv weight in 1,800 by
    0.064 * lr after five contrastive steps here)."""
    ref = convert.cnn_params_to_reference(port_params)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jax_params)):
        gap = np.abs(a - np.asarray(b))
        assert np.mean(gap <= 1e-2 * CNN_LR * steps) >= 0.999
        assert np.all(gap <= 2 * CNN_LR * steps)


@pytest.mark.parametrize("loss", ["layer_aware", "contrastive"])
def test_siamese_steps_match_jax(mnist_tiny, loss):
    jcfg, pcfg = JC.CNNConfig(**NARROW), PC.CNNConfig(**NARROW)
    jp = JC.init_cnn_params(jcfg, jax.random.PRNGKey(2))
    tp = convert.cnn_params(jax.tree.map(np.asarray, jp), "cpu")
    x1, x2, diff = (a[:40] for a in make_siamese_pairs(
        mnist_tiny.x_train, mnist_tiny.y_train, 200, seed=1))
    jfn = {"layer_aware": JL.layer_aware_loss,
           "contrastive": JL.final_layer_contrastive}[loss]
    jstep = _jax_siamese_step(jcfg, jfn)
    jo, to = j_adamw_init(jp), adamw_init(tp)
    pfn = TR.siamese_loss_fn(loss)
    for i in range(5):
        sl = slice(8 * i, 8 * i + 8)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(x1[sl]), jnp.asarray(x2[sl]),
                           jnp.asarray(diff[sl]))
        tp, to, tl = TR.siamese_step(
            pcfg, tp, to, torch.from_numpy(x1[sl]), torch.from_numpy(x2[sl]),
            torch.from_numpy(diff[sl]), loss_fn=pfn, lr=CNN_LR)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-6)
        _assert_cnn_close(tp, jp, i + 1)


def test_ce_steps_match_jax(mnist_tiny):
    jcfg, pcfg = JC.CNNConfig(**NARROW), PC.CNNConfig(**NARROW)
    key = jax.random.PRNGKey(3)
    jnet = JC.init_cnn_params(jcfg, key)
    jfull = {"net": jnet, "head": {
        "w": jax.random.normal(key, (NARROW["fcs"][-1], 10)) * 0.02,
        "b": jnp.zeros((10,))}}
    tfull = {"net": convert.cnn_params(jax.tree.map(np.asarray, jnet), "cpu"),
             "head": convert.tree(jax.tree.map(np.asarray, jfull["head"]),
                                  "cpu")}
    jstep = _jax_ce_step(jcfg)
    jo, to = j_adamw_init(jfull), adamw_init(tfull)
    x, y = mnist_tiny.x_train, mnist_tiny.y_train
    for i in range(5):
        sl = slice(16 * i, 16 * i + 16)
        jfull, jo, jl = jstep(jfull, jo, jnp.asarray(x[sl]),
                              jnp.asarray(y[sl]))
        tfull, to, tl = TR.ce_step(pcfg, tfull, to, torch.from_numpy(x[sl]),
                                   torch.from_numpy(y[sl]), lr=CNN_LR)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-6)
        _assert_cnn_close(tfull["net"], jfull["net"], i + 1)
        for a, b in zip(tree_leaves(tfull["head"]),
                        jax.tree.leaves(jfull["head"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-2 * CNN_LR * (i + 1))


def test_train_agile_cnn_end_to_end(mnist_tiny):
    """The whole pipeline (siamese layer-aware training, the bank, the
    thresholds) on the narrowed MNIST CNN, as the reference's conftest
    trains it: 2 epochs of 384 pairs."""
    out = train_agile_cnn(mnist_tiny, epochs=2, n_pairs=384, batch_size=32,
                          seed=0, cfg=PC.CNNConfig(**NARROW), device="cpu")
    h = np.asarray(out.history)
    assert len(h) == 2 * (384 // 32) and np.all(np.isfinite(h))
    assert h[-4:].mean() < h[:4].mean()
    assert len(out.bank) == out.cfg.n_units
    for uc in out.bank:
        assert np.isfinite(float(uc.threshold))
        assert uc.centroids.shape[0] == uc.labels.shape[0]
