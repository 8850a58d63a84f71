"""The anytime engine over a mesh against the reference's multi-device runs.

One JAX subprocess (``--xla_force_host_platform_device_count=4``) runs the
reference's ``AnytimeServeEngine.run(mesh=)`` for every case below (the
reference places the decode state by ``state_specs`` and its partitioner
splits the step) and saves the result arrays.  The port runs the same
engines (the reference's weights carried over) on ``make_mesh(shape,
("data", "model"), "cpu")``, the CPU device listed ``prod(shape)`` times,
and runs each step's model block by block:

* the result arrays equal the reference's mesh runs bit for bit;
* the port's decode state, gathered whole, is within 1e-5 of its run
  without a mesh.

The cases cover the TINY qwen1.5-0.5b of ``tests/test_torch_anytime.py``
on ``(2, 2)`` (slots and kv heads), ``(1, 4)`` (kv heads) and ``(4, 1)``
(slots), the reduced glm4-9b on ``(1, 4)`` (2 kv heads: the cache length
is cut, kernel H's slice entries and merge), the reduced
recurrentgemma-9b on ``(2, 2)`` (its one kv head's cache length, and the
RG-LRU state and conv buffer by width), and the reduced dbrx-132b (MoE),
xlstm-125m (cells by slots), seamless-m4t-medium (encoder-decoder: the
cross keys and values by head) and internvl2-2b (the VLM) on ``(2, 2)``.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
from repro_torch.serve import AnytimeConfig, AnytimeRequest
from repro_torch.serve import AnytimeServeEngine

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _subproc import sub_env  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RESULT_FIELDS = ("status", "finish", "tardiness", "agree", "tokens",
                 "depth_sum")
TINY = dict(n_layers=4, vocab=64, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=16, d_ff=128, exit_every=1)
#: a cache of 8 slots: the length divides over 2 and 4 blocks
SERVE = dict(batch_slots=4, max_steps=40, prompt_len=4, max_new_tokens=4)
#: (architecture, overrides of its reduced config, mesh shapes)
CASES = (("qwen1.5-0.5b", TINY, ((2, 2), (1, 4), (4, 1))),
         ("glm4-9b", {}, ((1, 4),)),
         ("recurrentgemma-9b", {}, ((2, 2),)),
         ("dbrx-132b", {}, ((2, 2),)),
         ("xlstm-125m", {}, ((2, 2),)),
         ("seamless-m4t-medium", {}, ((2, 2),)),
         ("internvl2-2b", {}, ((2, 2),)))
PARAMS = [(arch, shape) for arch, _, shapes in CASES for shape in shapes]

_REQUESTS = """
def requests(cls):
    return [cls(prompt=(1 + i % 5,) * (1 + i % 3), n_tokens=3,
                release=0.3 * i, deadline=0.3 * i + 2.5) for i in range(8)]
"""

_REF = """
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as T
from repro.serve import AnytimeConfig, AnytimeRequest, AnytimeServeEngine
""" + _REQUESTS + """
out = {}
for arch, over, shapes in %r:
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    eng = AnytimeServeEngine(cfg, params, serve_cfg=AnytimeConfig(**%r))
    for shape in shapes:
        res = eng.run(requests(AnytimeRequest),
                      mesh=make_mesh(shape, ("data", "model")))
        for f in %r:
            out[f"{arch}.{shape}.{f}"] = np.asarray(getattr(res, f))
np.savez(sys.argv[1], **out)
print("ANYTIME_MESH_REF_OK", jax.device_count())
""" % (CASES, SERVE, RESULT_FIELDS)

_scope: dict = {}
exec(_REQUESTS, _scope)
requests = _scope["requests"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("anytime_mesh") / "ref.npz"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF), str(path)],
        capture_output=True, text=True, timeout=600, env=sub_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ANYTIME_MESH_REF_OK 4" in out.stdout
    with np.load(path) as z:
        return dict(z)


_ENGINES: dict = {}


def _engine(arch):
    """The port's engine on the reference's weights (the JAX package's
    initialisation from PRNGKey(0), carried over), with its run without a
    mesh and that run's final decode state."""
    if arch not in _ENGINES:
        import jax

        from repro.configs import get_config as jget
        from repro.models import transformer as JT
        from repro_torch import convert

        over = dict((a, o) for a, o, _ in CASES)[arch]
        jcfg = dataclasses.replace(jget(arch).reduced(), **over)
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        params = convert.transformer_params(jax.tree.map(
            np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
        eng = AnytimeServeEngine(cfg, params,
                                 serve_cfg=AnytimeConfig(**SERVE))
        seen = {}
        plain = eng.run(requests(AnytimeRequest),
                        hook=lambda s, c, k: seen.update(state=c.state))
        _ENGINES[arch] = (eng, plain, seen["state"])
    return _ENGINES[arch]


@pytest.mark.parametrize("arch,shape", PARAMS,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in PARAMS])
def test_anytime_run_over_a_mesh_matches_jax(ref, arch, shape):
    eng, plain, plain_state = _engine(arch)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    seen = {}
    res = eng.run(requests(AnytimeRequest), mesh=mesh,
                  hook=lambda s, c, k: seen.update(state=c.state))
    for f in RESULT_FIELDS:
        want = ref[f"{arch}.{shape}.{f}"]
        got = getattr(res, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert res.completed == len(requests(AnytimeRequest))
    placed = SH._leaves(seen["state"])
    assert any(isinstance(x, SH.Sharded) and len({
        tuple((d.start, d.stop) for d in sl)
        for sl, _ in SH.block_layout(x)}) > 1 for x in placed)
    for a, b in zip(SH._leaves(SH.gather(seen["state"])),
                    SH._leaves(plain_state)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_the_cuts_are_the_specs():
    """The cases cut what they say: glm4-9b's 2 kv heads over 4 blocks cut
    the cache length, recurrentgemma-9b's one kv head its cache length and
    its RG-LRU state by width, qwen's 4 kv heads the heads."""
    def specs(arch, shape):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  **dict((a, o) for a, o, _ in CASES)[arch])
        st = T.init_decode_state(cfg, SERVE["batch_slots"], 8, cache_len=8,
                                 stacked=False, device="meta")
        return st, SH.state_specs(make_mesh(shape, ("data", "model"),
                                            "cpu"), st)

    _, sp = specs("glm4-9b", (1, 4))
    assert sp["stack"][0][0]["k"] == SH.P("data", "model", None, None)
    _, sp = specs("recurrentgemma-9b", (2, 2))
    attn = [layer for q in sp["stack"] for layer in q if "k" in layer]
    rec = [layer for q in sp["stack"] for layer in q if "h" in layer]
    assert attn[0]["k"] == SH.P("data", "model", None, None)
    assert rec[0]["h"] == SH.P("data", "model")
    assert rec[0]["buf"] == SH.P("data", None, "model")
    _, sp = specs("qwen1.5-0.5b", (2, 2))
    assert sp["stack"][0][0]["k"] == SH.P("data", None, "model", None)


def test_xlstm_cells_cut_past_their_rows_step_whole():
    """Three slots do not divide over ``data`` = 2, so ``state_specs`` cuts
    the xLSTM cells by a later dim; such a cell steps whole and is placed
    again, and the run equals the port's run without a mesh."""
    cfg = get_config("xlstm-125m").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = AnytimeServeEngine(cfg, params, serve_cfg=AnytimeConfig(
        **dict(SERVE, batch_slots=3)))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    seen = {}
    plain = eng.run(requests(AnytimeRequest),
                    hook=lambda s, c, k: seen.update(plain=c.state))
    res = eng.run(requests(AnytimeRequest), mesh=mesh,
                  hook=lambda s, c, k: seen.update(mesh=c.state))
    cells = [x for x in SH._leaves(seen["mesh"])
             if isinstance(x, SH.Sharded) and x.shape[0] == 3
             and x.dtype == torch.float32 and len(x.shape) > 1]
    assert any(any(sl[0] != slice(0, 3) or any(
        d != slice(0, n) for d, n in zip(sl[1:], c.shape[1:]))
        for sl, _ in SH.block_layout(c)) for c in cells)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(plain, f),
                                      err_msg=f)
    assert res.completed == len(requests(AnytimeRequest))
    for a, b in zip(SH._leaves(SH.gather(seen["mesh"])),
                    SH._leaves(seen["plain"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q,kind", [(0, "mlstm"), (1, "slstm")])
def test_xlstm_cell_step_over_a_mesh_equals_the_step_without(q, kind):
    """One mLSTM and one sLSTM step of the reduced xlstm-125m with its cell
    placed on a ``(2, 2)`` mesh (rows cut over ``data``) equals the step
    without a mesh bit for bit: the cell steps whole, so its products with
    replicated weights take all four rows at once in both."""
    cfg = get_config("xlstm-125m").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p = T._index(params["layers"]["stack"][q], 0)
    st = T.init_decode_state(cfg, 4, 8, cache_len=8, stacked=False,
                             device="cpu")
    rng = np.random.default_rng(q)
    cell = tuple(torch.from_numpy(rng.normal(size=c.shape).astype(np.float32))
                 for c in st["stack"][q][0]["cell"])
    stack = list(st["stack"])
    stack[q] = (dict(stack[q][0], cell=cell),) + tuple(stack[q][1:])
    st = dict(st, stack=tuple(stack))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    placed = SH.device_put(st, SH.named(mesh, SH.state_specs(mesh, st)))
    pcell = placed["stack"][q][0]["cell"]
    assert all(len({sl[0] for sl, _ in SH.block_layout(c)}) == 2
               for c in pcell)
    h = torch.from_numpy(rng.normal(size=(4, cfg.d_model)).astype(np.float32))
    y0, new0 = T._xlstm_cell_step(p, cfg, kind, h, cell)
    y1, new1 = T._xlstm_cell_step(p, cfg, kind, h, pcell)
    assert torch.equal(y1, y0)
    for a, b in zip(new1, new0):
        assert isinstance(a, SH.Sharded)
        assert torch.equal(SH.gather(a), b)
