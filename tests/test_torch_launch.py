"""The port's launch drivers (``python -m repro_torch.launch.train`` and
``... .serve``) as subprocesses on the CPU (``--device cpu``), mirroring
``tests/test_launch.py``: the reduced qwen1.5-0.5b training run, the
reduced xlstm-125m run with a checkpoint, whose ``.npz`` loads into the JAX
package's ``load_checkpoint`` against the reference's ``init_params`` tree
with the same keys and shapes (and equal to the port's own load of it), a
small scalar and a small anytime serving run, and a run without
``--device cpu``, which on a machine without a CUDA card exits non-zero
and names the card.  Each child runs PyTorch on two threads (the suite runs
several workers at once).
"""
import json
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from _subproc import sub_env

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.train import load_checkpoint as j_load_checkpoint

from repro_torch.configs import get_config
from repro_torch.models import transformer as PT
from repro_torch.train import load_checkpoint
from repro_torch.train.optimizer import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401


def run_module(args, timeout=600, ok=True):
    env = dict(sub_env(), OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m"] + args,
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    if ok:
        assert out.returncode == 0, out.stderr[-3000:]
    return out


def _losses(text):
    return [float(line.split("loss")[1].split()[0])
            for line in text.splitlines() if line.startswith("step")]


def test_train_driver_reduced():
    out = run_module([
        "repro_torch.launch.train", "--arch", "qwen1.5-0.5b", "--reduced",
        "--steps", "6", "--batch", "4", "--seq", "32", "--log-every", "5",
        "--device", "cpu",
    ]).stdout
    assert "step     0" in out and "step     5" in out
    assert "done: 6 steps" in out
    losses = _losses(out)
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_driver_checkpoint_loads_into_the_reference(tmp_path):
    out = run_module([
        "repro_torch.launch.train", "--arch", "xlstm-125m", "--reduced",
        "--steps", "4", "--batch", "2", "--seq", "16",
        "--ckpt-every", "4", "--ckpt-path", str(tmp_path / "ck"),
        "--device", "cpu",
    ]).stdout
    path = tmp_path / "ck_4.npz"
    assert f"checkpoint -> {path}" in out and path.exists()
    jcfg = jget("xlstm-125m").reduced()
    like = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(like)[0]
    keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path_) for path_, _ in flat]
    with np.load(path) as data:
        assert sorted(data.files) == sorted(keys)
        for key, (_, leaf) in zip(keys, flat):
            assert data[key].shape == leaf.shape, key
    ref = jax.tree.leaves(j_load_checkpoint(str(path), like))
    cfg = get_config("xlstm-125m").reduced()
    mine = tree_leaves(load_checkpoint(str(path), PT.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")))
    assert len(ref) == len(mine)
    for a, b in zip(ref, mine):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def _json_block(text):
    """The indented JSON object a serve run prints."""
    start = text.index("{\n")
    end = text.index("\n}", start) + 2
    return json.loads(text[start:end])


def test_serve_driver_scalar():
    out = run_module([
        "repro_torch.launch.serve", "--engine", "scalar", "--tasks", "mnist",
        "--requests", "4", "--device", "cpu",
    ]).stdout
    res = _json_block(out)
    assert res["released"] == 4 and 0 <= res["scheduled"] <= 4
    assert "of scheduled classified correctly" in out


def test_serve_driver_anytime():
    out = run_module([
        "repro_torch.launch.serve", "--engine", "anytime",
        "--arch", "qwen1.5-0.5b", "--requests", "4", "--device", "cpu",
    ]).stdout
    assert "anytime-serving 4 requests on qwen1.5-0.5b" in out
    res = _json_block(out)
    assert res["n_requests"] == 4
    assert res["completed"] == res["on_time"] + res["missed"]


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.serve"])
def test_drivers_without_a_card_name_it(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = run_module([module, "--arch", "xlstm-125m", "--reduced"]
                     if module.endswith("train") else [module], ok=False)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr and "--device cpu" in out.stderr
