"""The port's training parts against the JAX package.

* ``make_siamese_pairs``, ``make_token_dataset``, ``make_lm_tokens``,
  ``batches`` and ``siamese_batches``: numpy, bit-equal to the reference's.
* ``adamw_update`` bit for bit against ``jax.jit(adamw_update)`` from the
  same (converted) parameters, gradients and state: XLA's CPU summation
  order for the global norm, its four contracted multiply-adds, its
  ``powf`` and its correctly rounded ``sqrt`` (see
  ``repro_torch/train/optimizer.py``), with clipping active and inactive,
  bf16 parameters, several steps, and a reduced transformer's tree;
  ``xla_sum_of_squares`` against ``jax.jit(jnp.sum(x * x))`` on one leaf
  of each loop-nest family (the summation orders are LLVM's choices for
  this host's x86 CPU).
* Checkpoints both ways: a transformer tree written by the JAX package
  loads into the port and one written by the port loads into the JAX
  package, leaf for leaf; a CNN round-trips within the port.
"""
import functools
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro import data as JD
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.train import checkpoint as JC
from repro.train import optimizer as JO

from repro_torch import convert
from repro_torch import data as PD
from repro_torch.models import cnn
from repro_torch.train import checkpoint as PC
from repro_torch.train import optimizer as PO


def test_make_siamese_pairs_matches_reference(mnist_tiny):
    for seed in (0, 3):
        got = PD.make_siamese_pairs(mnist_tiny.x_train, mnist_tiny.y_train,
                                    97, seed=seed)
        want = JD.make_siamese_pairs(mnist_tiny.x_train, mnist_tiny.y_train,
                                     97, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_token_and_lm_data_match_reference():
    for a, b in zip(PD.make_token_dataset(64, 12, 5, 30, seed=2),
                    JD.make_token_dataset(64, 12, 5, 30, seed=2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = PD.make_lm_tokens(101, 33, 7, seed=4), JD.make_lm_tokens(
        101, 33, 7, seed=4)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("drop", [True, False])
def test_batches_match_reference(drop):
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(45, 3)), rng.integers(0, 4, 45)
    got = list(PD.batches(x, y, 8, seed=5, epochs=2, drop_remainder=drop))
    want = list(JD.batches(x, y, 8, seed=5, epochs=2, drop_remainder=drop))
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    x2, d2 = rng.normal(size=(45, 3)), rng.integers(0, 2, 45)
    got = list(PD.siamese_batches(x, x2, d2, 8, seed=1, epochs=3))
    want = list(JD.siamese_batches(x, x2, d2, 8, seed=1, epochs=3))
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


def _leaf_pairs(port_tree, jax_tree):
    """Port and JAX leaves side by side, in JAX's flatten order."""
    port = PO.tree_leaves(port_tree)
    ref = jax.tree.leaves(jax_tree)
    assert len(port) == len(ref)
    return zip(port, ref)


def _bits(t):
    return t.detach().float().numpy().view(np.int32)


def _ref_bits(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).view(np.int32)


SHAPES = {"w": (300, 70), "b": (70,), "stack": ((3, 40, 33), (2, 31, 100)),
          "a": (1000,), "s": (5,)}


def _tree(shapes, f):
    if isinstance(shapes, dict):
        return {k: _tree(v, f) for k, v in shapes.items()}
    if isinstance(shapes[0], tuple):
        return tuple(_tree(s, f) for s in shapes)
    return f(shapes)


@pytest.mark.parametrize("case", ["clipped", "unclipped", "no clip", "bf16",
                                  "large lr"])
def test_adamw_update_bit_equal_to_jit(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    gscale = {"clipped": 1.0, "bf16": 1.0}.get(case, 1e-4)
    kw = dict(grad_clip=0.0) if case == "no clip" else {}
    if case == "large lr":
        kw.update(lr=0.05, weight_decay=0.3)
    params = _tree(SHAPES, lambda s: rng.normal(size=s).astype(np.float32))
    jp = jax.tree.map(jnp.asarray, params)
    if case == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    state = JO.adamw_init(jp)
    step = jax.jit(functools.partial(JO.adamw_update, **kw))
    tp = convert.tree(jax.tree.map(np.asarray, jp), "cpu")
    ts = convert.adamw_state(jax.tree.map(np.asarray, state), "cpu")
    for _ in range(3):  # a few steps from the same state in both
        grads = _tree(SHAPES, lambda s: (rng.normal(size=s) * gscale).astype(
            np.float32))
        jg = jax.tree.map(jnp.asarray, grads)
        if case == "bf16":
            jg = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jg)
        jp, state = step(jp, jg, state)
        tp, ts = PO.adamw_update(
            tp, convert.tree(jax.tree.map(np.asarray, jg), "cpu"), ts, **kw)
        assert int(ts.step) == int(state.step)
        for tree_p, tree_j in ((tp, jp), (ts.mu, state.mu),
                               (ts.nu, state.nu)):
            for a, b in _leaf_pairs(tree_p, tree_j):
                assert a.dtype == convert.tensor(np.asarray(b), "cpu").dtype
                assert np.array_equal(_bits(a), _ref_bits(b)), case


def test_adamw_update_bit_equal_on_a_transformer_tree():
    cfg = jget("qwen1.5-0.5b").reduced()
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)).astype(p.dtype), jp)
    state = JO.adamw_init(jp)
    new_j, st_j = jax.jit(JO.adamw_update)(jp, jg, state)
    new_p, st_p = PO.adamw_update(
        convert.transformer_params(jax.tree.map(np.asarray, jp), "cpu"),
        convert.transformer_params(jax.tree.map(np.asarray, jg), "cpu"),
        convert.adamw_state(jax.tree.map(np.asarray, state), "cpu"))
    for tree_p, tree_j in ((new_p, new_j), (st_p.mu, st_j.mu),
                           (st_p.nu, st_j.nu)):
        for a, b in _leaf_pairs(tree_p, tree_j):
            assert np.array_equal(_bits(a), _ref_bits(b))


NORM_SHAPES = [(5,), (31,), (32,), (33,), (70,), (1025,), (5, 40), (64, 64),
               (3, 64, 33), (33, 2, 65), (1000, 70), (24, 64, 96), (40, 40),
               (100, 100), (256, 192)]
# the witnesses of the norm-order fault (ROADMAP Queue 3, PR 24), each
# over seeds 0-7 with gradient = parameters = default_rng(seed).normal
NORM_WITNESSES = [(64, 64, 2), (2, 2, 32, 32), (2, 2), (64, 64, 64),
                  (512, 192), (512, 256), (512, 512)]
NORM_CASES = (
    [pytest.param(s, None, id=f"shape{i}") for i, s in enumerate(NORM_SHAPES)]
    + [pytest.param(s, seed, id="x".join(map(str, s)) + f"-seed{seed}")
       for s in NORM_WITNESSES for seed in range(8)])


@pytest.mark.parametrize("shape,seed", NORM_CASES)
def test_adamw_global_norm_order(shape, seed):
    """One leaf, clipping active: the clip scale, and with it every moment,
    carries the bits of the leaf's sum of squares in XLA's CPU order
    (``optimizer.xla_sum_of_squares``): the window grids LLVM vectorises
    across their rows (2 x 2, 4 x 4, 8 x 6, 16 x 6 at 8 lanes, 16 x 8 at
    4), a window whose short inner axis is interleaved into 8-lane rows
    (32 x 32 x 2), a 2 x 2 x 2 grid's vector loop inside a scalar one, and
    leaves with no axis over 32, whose squares are fused into the reduce
    as fused multiply-adds ((2, 2, 32, 32), (2, 2)).  The vector widths
    and the fused multiply-adds are LLVM's choices for this host's x86
    CPU (AVX-512, XLA's preferred 256-bit vectors): a host whose cost
    model picks other widths sums in another order.  ``seed`` None: the
    parameters and the gradient are two draws of ``default_rng(1)``."""
    if seed is None:
        rng = np.random.default_rng(1)
        p = {"x": jnp.asarray(rng.normal(size=shape).astype(np.float32))}
        g = {"x": jnp.asarray(rng.normal(size=shape).astype(np.float32))}
    else:
        x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        p = g = {"x": jnp.asarray(x)}
    state = JO.adamw_init(p)
    new_j, st_j = jax.jit(JO.adamw_update)(p, g, state)
    new_p, st_p = PO.adamw_update(
        convert.tree(jax.tree.map(np.asarray, p), "cpu"),
        convert.tree(jax.tree.map(np.asarray, g), "cpu"),
        convert.adamw_state(jax.tree.map(np.asarray, state), "cpu"))
    assert np.array_equal(_bits(st_p.mu["x"]), _ref_bits(st_j.mu["x"]))
    assert np.array_equal(_bits(new_p["x"]), _ref_bits(new_j["x"]))


# one leaf of each loop-nest family of XLA's CPU sum of squares: fused
# scalar chains, fused vector loops (groups of up to four members by
# fused multiply-adds, of five to eight by rounded squares), vectorised
# window grids at 8 and 4 lanes with a scalar epilogue, a padded window
# loop kept scalar, padding only on a window's last index (unswitched),
# and a second level of windows
SUM_FAMILIES = [(7,), (3, 5), (8, 3), (8, 6), (4, 3, 7), (2, 2, 2, 2),
                (17, 3), (20, 2), (28, 2), (16, 7), (40, 8), (70, 64, 6),
                (3, 63), (63, 3), (63, 63, 2), (2, 63, 63), (6, 63, 9, 27),
                (65, 32, 4), (48, 19, 2, 6), (1100, 1100), (40000,)]


@pytest.mark.parametrize("shape", SUM_FAMILIES)
def test_xla_sum_of_squares_matches_jit(shape):
    """``xla_sum_of_squares`` == ``jax.jit(lambda x: jnp.sum(x * x))`` bit
    for bit on seeds 0-3.  The vector widths and which adds are fused
    multiply-adds are LLVM's choices for this host's x86 CPU (AVX-512,
    XLA's preferred 256-bit vectors), read from the dumped IR
    (``XLA_FLAGS=--xla_dump_to``); another host's cost model may pick
    others."""
    f = jax.jit(lambda x: jnp.sum(x * x))
    for seed in range(4):
        x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        want = np.asarray(f(jnp.asarray(x)))
        got = PO.xla_sum_of_squares(torch.from_numpy(x)).numpy()
        assert want.view(np.uint32) == got.view(np.uint32), (shape, seed)


def test_transformer_checkpoint_loads_both_ways(tmp_path):
    cfg = jget("recurrentgemma-9b").reduced()
    jp = JT.init_params(cfg, jax.random.PRNGKey(1))
    tp = convert.transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    # JAX -> port
    JC.save_checkpoint(str(tmp_path / "jax.npz"), jp)
    loaded = PC.load_checkpoint(str(tmp_path / "jax.npz"), tp)
    for a, b in _leaf_pairs(loaded, jp):
        assert a.dtype == convert.tensor(np.asarray(b), "cpu").dtype
        assert np.array_equal(_bits(a), _ref_bits(b))
    # port -> JAX, keys included
    PC.save_checkpoint(str(tmp_path / "port.npz"), tp)
    assert sorted(np.load(tmp_path / "port.npz").files) == sorted(
        np.load(tmp_path / "jax.npz").files)
    back = JC.load_checkpoint(str(tmp_path / "port"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        assert np.array_equal(_ref_bits(a), _ref_bits(b))


def test_cnn_checkpoint_round_trips_and_rejects_a_wrong_shape(tmp_path):
    cfg = cnn.PAPER_CNNS["mnist"]
    params = cnn.init_cnn_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    PC.save_checkpoint(str(tmp_path / "cnn.npz"), params)
    back = PC.load_checkpoint(str(tmp_path / "cnn"), params)
    for a, b in zip(PO.tree_leaves(back), PO.tree_leaves(params)):
        assert torch.equal(a, b)
    # the OIHW weights carried to the reference's layout and back
    ref = convert.cnn_params_to_reference(params)
    again = convert.cnn_params(ref, "cpu")
    for a, b in zip(PO.tree_leaves(again), PO.tree_leaves(params)):
        assert torch.equal(a, b)
    other = cnn.init_cnn_params(cnn.PAPER_CNNS["esc10"],
                                torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises((ValueError, KeyError)):
        PC.load_checkpoint(str(tmp_path / "cnn"), other)
