"""The port's meshes and spec tables (``repro_torch.launch.mesh``,
``.sharding``, ``models.common.sanitize_dim``) against the reference's.

Every assigned config at full width: the port's parameter tree on the
``meta`` device (nothing drawn) gets the specs the reference infers from
``jax.eval_shape(init_params)``, leaf by leaf, on the single-pod (16, 16)
and multi-pod (2, 16, 16) layouts; so do the AdamW moments, the decode
state at ``decode_32k``, the token batch at ``train_4k``, the logits and a
fleet config.  Placement over a mesh of CPU entries cuts and joins what
the specs say.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_fallback import given, settings, st

import jax
from jax.sharding import PartitionSpec as JP

from repro import fleet as JF
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import inputs as JI
from repro.launch import mesh as JM
from repro.launch import sharding as JS
from repro.models import transformer as JT
from repro.models.common import sanitize_dim as j_sanitize_dim
from repro.train.optimizer import adamw_init as j_adamw_init

from repro_torch.configs import get_config
from repro_torch.launch import inputs as PI
from repro_torch.launch import mesh as PM
from repro_torch.launch import sharding as PS
from repro_torch.models import transformer as PT
from repro_torch.models.common import sanitize_dim
from repro_torch.train import adamw_init

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _workloads as W  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_fleet import port_cfg  # noqa: E402

AXES = {"data": 16, "model": 16, "pod": 2}
LAYOUTS = {"single-pod": ((16, 16), ("data", "model")),
           "multi-pod": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(layout):
    shape, axes = LAYOUTS[layout]
    return (JM.make_abstract_mesh(shape, axes),
            PM.make_abstract_mesh(shape, axes))


def flat(tree) -> list:
    """Leaves in JAX's flatten order (dict keys sorted), a spec a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, PS.P):
        return [x for v in tree for x in flat(v)]
    return [tree]


def j_flat_specs(tree) -> list:
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, JP))]


def assert_same_specs(p_specs, j_specs, p_tree, j_tree, what):
    p_leaves, j_leaves = flat(p_tree), jax.tree.leaves(j_tree)
    assert [tuple(x.shape) for x in p_leaves] == [
        tuple(x.shape) for x in j_leaves], what
    assert [tuple(s) for s in flat(p_specs)] == j_flat_specs(j_specs), what


@functools.lru_cache(maxsize=None)
def j_params(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda: JT.init_params(cfg, jax.random.key(0)))


@given(st.integers(1, 1 << 20),
       st.lists(st.sampled_from(["data", "model", "pod"]), max_size=3,
                unique=True))
@settings(max_examples=200, deadline=None)
def test_sanitize_dim_matches_reference(dim, axes):
    """Over ``tests/test_sharding_props.py``'s strategy, as a tuple and as
    a single name."""
    a = tuple(axes) if axes else None
    assert sanitize_dim(a, dim, AXES) == j_sanitize_dim(a, dim, AXES)
    if axes:
        assert (sanitize_dim(axes[0], dim, AXES)
                == j_sanitize_dim(axes[0], dim, AXES))


def test_logical_rules_and_meshes():
    """``logical_rules`` equals the reference's on the host, single-pod and
    multi-pod layouts; the port's meshes report the reference's axis sizes;
    a production mesh on a machine without its cards is a ValueError that
    names the count needed and the count visible, as the reference's is on
    this host."""
    host = PM.make_host_mesh(device="cpu")
    assert PM.logical_rules(host) == JM.logical_rules(JM.make_host_mesh())
    assert host.shape == dict(JM.make_host_mesh().shape) == {"data": 1,
                                                             "model": 1}
    for layout in LAYOUTS:
        jm, pm = meshes(layout)
        assert PM.logical_rules(pm) == JM.logical_rules(jm)
        assert pm.shape == dict(jm.shape) and pm.size == jm.size
    fleet = PM.make_fleet_mesh(4, device="cpu")
    assert fleet.shape == {"dev": 4} and fleet.devices.shape == (4,)
    assert all(d == torch.device("cpu") for d in fleet.devices.flat)
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} CUDA cards; "
                           f"{torch.cuda.device_count()} "):
            PM.make_production_mesh(multi_pod=multi)
        with pytest.raises(ValueError):
            JM.make_production_mesh(multi_pod=multi)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_and_adamw_specs_match_reference(arch):
    """The whole-size parameter tree on ``meta`` (nothing drawn) has the
    reference's shapes and dtypes, and ``param_specs`` of it and of its
    AdamW state equal the reference's leaf by leaf on both pod layouts."""
    shapes = PT.init_params(get_config(arch), device="meta")
    j_shapes = j_params(arch)
    assert [str(x.dtype).removeprefix("torch.") for x in flat(shapes)] == [
        str(x.dtype) for x in jax.tree.leaves(j_shapes)]
    opt, j_opt = adamw_init(shapes), jax.eval_shape(j_adamw_init, j_shapes)
    for layout in LAYOUTS:
        jm, pm = meshes(layout)
        assert_same_specs(PS.param_specs(pm, shapes),
                          JS.param_specs(jm, j_shapes), shapes, j_shapes,
                          f"{arch} params, {layout}")
        assert_same_specs(PS.param_specs(pm, opt), JS.param_specs(jm, j_opt),
                          opt, j_opt, f"{arch} AdamW, {layout}")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_state_batch_and_logits_specs_match_reference(arch):
    """``state_specs`` of the decode state at ``decode_32k``,
    ``batch_specs`` of the ``train_4k`` batch and ``logits_spec`` equal the
    reference's on both pod layouts."""
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    state = PI.input_specs(cfg, "decode_32k").args[0]
    j_state = JI.input_specs(j_cfg, "decode_32k").args[0]
    batch = PI.input_specs(cfg, "train_4k").args[0]
    j_batch = JI.input_specs(j_cfg, "train_4k").args[0]
    for layout in LAYOUTS:
        jm, pm = meshes(layout)
        assert_same_specs(PS.state_specs(pm, state),
                          JS.state_specs(jm, j_state), state, j_state,
                          f"{arch} decode state, {layout}")
        assert_same_specs(PS.batch_specs(pm, batch),
                          JS.batch_specs(jm, j_batch), batch, j_batch,
                          f"{arch} batch, {layout}")
        for b, ndim in ((256, 3), (128, 2), (1, 2), (3, 3)):
            assert tuple(PS.logits_spec(pm, b, cfg.padded_vocab, ndim)) == \
                tuple(JS.logits_spec(jm, b, j_cfg.padded_vocab, ndim))


def test_fleet_specs_match_reference():
    """``fleet_specs`` of a FleetConfig and of its carry on a fleet mesh
    and on the single-pod layout equal the reference's."""
    harv, _ = W.MODES["intermittent"]
    grid = JF.SweepGrid(task=W.random_task_set(W.TASK_SET_SEEDS[2], 2),
                        policies=("zygarde", "rr"), etas=(0.5, 1.0),
                        harvesters=(harv,), horizon=2.0, dt=W.DT)
    j_cfg, j_statics, _ = JF.build(grid)
    cfg = port_cfg(j_cfg)
    for jm, pm in ((JM.make_abstract_mesh((4,), ("dev",)),
                    PM.make_abstract_mesh((4,), ("dev",))),
                   meshes("single-pod")):
        assert [tuple(s) for s in PS.fleet_specs(pm, cfg)] == j_flat_specs(
            JS.fleet_specs(jm, j_cfg))


def test_placement_cuts_and_joins():
    """A fleet config over a 4-entry CPU mesh: ``D`` = 6 wraps to 8 rows
    (``arange(8) % 6``), each block holds 2, and ``gather`` returns the
    padded whole; a 2 x 2 mesh cuts each dim a spec names over its axis
    (replicating the rest) and ``gather`` inverts it; a one-device mesh
    places a tensor as itself."""
    x = torch.arange(6 * 3, dtype=torch.float32).reshape(6, 3)
    mesh = PM.make_fleet_mesh(4, device="cpu")
    placed = PS.shard_fleet_config(mesh, {"x": x})
    blocks = PS.blocks(placed)
    assert len(blocks) == 4 and all(b["x"].shape == (2, 3) for b in blocks)
    assert torch.equal(PS.gather(placed)["x"], x[torch.arange(8) % 6])
    assert torch.equal(PS.join(blocks)["x"], x[torch.arange(8) % 6])
    assert torch.equal(PS.take_rows(PS.join(blocks), 6)["x"], x)
    grid = PM.make_mesh((2, 2), ("data", "model"), device="cpu")
    y = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    for spec in (PS.P("data", "model"), PS.P(None, ("data", "model")),
                 PS.P("model"), PS.P()):
        s = PS.device_put(y, PS.NamedSharding(grid, spec))
        assert len(s.blocks) == 4
        assert torch.equal(PS.gather(s), y), spec
    cut = PS.device_put(y, PS.NamedSharding(grid, PS.P("data", "model")))
    assert torch.equal(cut.blocks[1], y[:2, 4:])      # data 0, model 1
    assert torch.equal(cut.blocks[2], y[2:, :4])      # data 1, model 0
    with pytest.raises(ValueError, match="divide"):
        PS.device_put(torch.ones(3, 3), PS.NamedSharding(grid,
                                                         PS.P("data")))
    with pytest.raises(ValueError, match="axis"):
        PS.device_put(y, PS.NamedSharding(grid, PS.P("dev")))
    one = PS.device_put(y, PS.NamedSharding(PM.make_host_mesh("cpu"),
                                            PS.P("data", None, "model")))
    assert one.blocks[0] is y and PS.gather(one) is y
    assert np.array_equal(PS.named(grid, {"a": PS.P("data")})["a"].spec,
                          ("data",))


def test_train_driver_meshes(capsys):
    """``launch.train --mesh host`` places the parameters and AdamW state
    by their specs on the 1 x 1 host mesh (whole on the one device) and
    trains as the same steps without a mesh do, bit for bit; ``--mesh
    single-pod`` / ``multi-pod`` exit 1 naming the cards needed and the
    cards visible."""
    from repro_torch.data import make_lm_tokens
    from repro_torch.launch import train as TR
    from repro_torch.train import make_train_step

    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "16", "--log-every", "1",
            "--device", "cpu"]
    out = TR.main(argv + ["--mesh", "host"])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=3e-4)
    tokens = make_lm_tokens(cfg.vocab, 16, 4, seed=0)
    for i in range(2):
        params, opt, _ = step(params, opt, {"tokens": torch.from_numpy(
            tokens[2 * i:2 * i + 2])})
    assert all(torch.equal(a, b) for a, b in zip(flat(out["params"]),
                                                 flat(params)))
    for kind, n in (("single-pod", 256), ("multi-pod", 512)):
        with pytest.raises(SystemExit) as e:
            TR.main(argv + ["--mesh", kind])
        assert e.value.code == 1
        err = capsys.readouterr().err
        assert f"needs {n} CUDA cards; {torch.cuda.device_count()} " in err
