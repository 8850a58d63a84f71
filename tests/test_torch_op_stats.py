"""The port's roofline terms, useful work and memory record
(``repro_torch.launch.op_stats``) against the reference's
``repro.launch.hlo_stats`` and spec tables, and each kernel's ``work()``
against the bounds ``PERF.md`` prints for it (the H100's data-sheet
peaks; ``chip_smoke.py`` reads the same functions).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import hlo_stats as JH
from repro.launch import inputs as JI
from repro.launch import mesh as JM
from repro.launch import sharding as JS
from repro.models import transformer as JT
from repro.train.optimizer import adamw_init as j_adamw_init

from repro_torch.configs import get_config
from repro_torch.kernels import centroid_update as CU
from repro_torch.kernels import decode_gqa as DG
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import fleet_priority as FP
from repro_torch.kernels import fleet_step as FS
from repro_torch.kernels import l1_topk2 as L1
from repro_torch.kernels import pairwise_l1 as PW
from repro_torch.kernels import rglru_scan as RS
from repro_torch.launch import op_stats as OS
from repro_torch.launch.lowering import lower_step
from repro_torch.launch.mesh import make_abstract_mesh
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_reference(arch, shape):
    s = INPUT_SHAPES[shape]
    want = JH.model_flops(j_get_config(arch), s.kind, s.global_batch,
                          s.seq_len)
    assert OS.model_flops(get_config(arch), s.kind, s.global_batch,
                          s.seq_len) == want


def test_roofline_terms_follow_the_peaks():
    t = OS.roofline_terms(flops=3e12, bytes_accessed=2e9, ici_bytes=9e8,
                          tc_flops=1e12)
    assert t["compute_s"] == pytest.approx(1e12 / 989e12 + 2e12 / 67e12)
    assert t["memory_s"] == pytest.approx(2e9 / 3.35e12)
    assert t["collective_s"] == pytest.approx(9e8 / 450e9)
    assert t["dominant"] == "compute"
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"],
                               t["collective_s"])
    assert t["compute_fraction_of_bound"] == 1.0
    m = OS.roofline_terms(flops=1e9, bytes_accessed=1e12, ici_bytes=0.0)
    assert m["dominant"] == "memory"
    assert m["compute_fraction_of_bound"] == pytest.approx(
        (1e9 / 67e12) / (1e12 / 3.35e12))
    assert OS.roofline_terms(flops=0, bytes_accessed=0,
                             ici_bytes=0)["compute_fraction_of_bound"] == 0.0


def test_ring_bytes_are_the_reference_factors():
    assert OS.ring_bytes("all-gather", 800, 8) == 700
    assert OS.ring_bytes("reduce-scatter", 100, 8) == 700
    assert OS.ring_bytes("all-reduce", 800, 8) == 1400
    assert OS.ring_bytes("all-to-all", 800, 8) == 700
    st = OS.collective_stats([("_c10d_functional.all_reduce", 800, 8),
                              ("mm", 64, None)], 16)
    assert st.as_dict() == {"ici_bytes": 1400.0, "raw_bytes": 800,
                            "counts": {"all-reduce": 1},
                            "by_kind_bytes": {"all-reduce": 1400.0}}


def _priority_in_bytes(D, Q):
    return sum(D * (1 if f in FP._IN_VEC else Q)
               * FP._DTYPES.get(f, torch.float32).itemsize
               for f in FP._IN_VEC + FP._IN_ROW)


def _kept(B, C, window):
    """Kernel H's kept slots on ``chip_smoke.py``'s decode inputs: row
    positions from C - 1 down to C // 2, the slots past them empty."""
    pos = torch.linspace(C - 1, C // 2, B).to(torch.int32)
    slots = torch.arange(C, dtype=torch.int32)
    slot_pos = torch.where(slots[None] <= pos[:, None], slots[None], -1)
    return int(DG.kept_slots(slot_pos, pos, window).sum())


def _h(B, H, KV, hd, C, dtype, window):
    return DG.work(B, H, KV, hd, C, getattr(torch, dtype),
                   n_valid=_kept(B, C, window))


def _g(shape, dtype, bwd=False):
    B, S, Skv, H, KV, hd, causal, window, qo = shape
    fn = FA.bwd_work if bwd else FA.work
    return fn(B, S, Skv, H, KV, hd, dtype, causal=causal, window=window,
              q_offset=qo)


BF16, F32 = torch.bfloat16, torch.float32
QWEN = (1, 4096, 4096, 16, 16, 64, True, 0, 0)
DBRX_BWD = (1, 1024, 1024, 48, 8, 128, True, 0, 0)
HYBRID = (1, 4096, 4096, 16, 1, 256, True, 2048, 0)
NONCAUSAL = (1, 512, 1024, 16, 16, 64, False, 0, 512)
HD80 = (1, 4096, 4096, 32, 32, 80, True, 0, 0)

#: (kernel, work, the bound column of PERF.md §6 in ms, as printed)
PERF_BOUNDS = [
    ("A", FP.work(1600, 3, _priority_in_bytes(1600, 3)), "0.000062"),
    ("B", FS.fleet_work(1600, 3, 1159, 0, 0), "0.003321"),
    ("D", L1.work(64, 5, 150, per_row=True), "0.000069"),
    ("D", L1.work(250, 5, 150), "0.000047"),
    ("D", L1.work(1, 5, 150), "0.000001"),
    ("E", CU.work(5, 8192, 64, n_valid=15), "0.000245"),
    ("E", CU.work(8, 8192, 1024), "0.010174"),
    ("E", CU.work(5, 8192, 1, n_valid=1), "0.000108"),
    ("F", PW.work(256, 256, 6), "0.000082"),
    ("F", PW.work(4096, 4096, 512), "0.384624"),
    ("G", _g((2, 512, 512, 16, 16, 64, True, 0, 0), BF16), "0.00313"),
    ("G", _g(QWEN, BF16), "0.0348"),
    ("G", _g((1, 8192, 8192, 16, 16, 64, True, 4096, 0), BF16), "0.104"),
    ("G", _g((1, 4096, 4096, 32, 2, 128, True, 0, 0), BF16), "0.139"),
    ("G", _g(HYBRID, BF16), "0.104"),
    ("G", _g((1, 4096, 4096, 48, 8, 128, True, 0, 0), BF16), "0.2085"),
    ("G", _g((1, 4096, 4096, 64, 4, 128, True, 0, 0), BF16), "0.2780"),
    ("G", _g((1, 1024, 1024, 16, 16, 64, False, 0, 0), BF16), "0.00434"),
    ("G", _g((2, 512, 1024, 16, 16, 64, False, 0, 0), BF16), "0.00438"),
    ("G", _g((1, 4096, 4096, 16, 8, 128, True, 0, 0), BF16), "0.0695"),
    ("G", _g(HD80, BF16), "0.0869"),
    ("H", _h(1, 16, 1, 256, 2176, "bfloat16", 2048), "0.000636"),
    ("H", _h(16, 16, 1, 256, 64, "bfloat16", 2048), "0.000354"),
    ("H", _h(1, 16, 16, 64, 4160, "bfloat16", 0), "0.005093"),
    ("H", _h(1, 32, 2, 128, 4096, "float32", 16), "0.000025"),
    ("H", _h(1, 48, 8, 128, 4128, "bfloat16", 0), "0.005063"),
    ("H", _h(16, 48, 8, 128, 64, "bfloat16", 0), "0.001118"),
    ("H", _h(1, 16, 16, 64, 1024, "bfloat16", 0), "0.001255"),
    ("I", RS.work(1, 4096, 4096), "0.060102"),
    ("I", RS.work(2, 512, 4096), "0.015034"),
    ("G bwd", _g(QWEN, BF16, True), "0.0869"),
    ("G bwd", _g(QWEN, F32, True), "1.2824"),
    ("G bwd", _g(DBRX_BWD, BF16, True), "0.0326"),
    ("G bwd", _g(DBRX_BWD, F32, True), "0.4812"),
    ("G bwd", _g(HYBRID, BF16, True), "0.2607"),
    ("G bwd", _g(HYBRID, F32, True), "3.8481"),
    ("G bwd", _g(NONCAUSAL, BF16, True), "0.0054"),
    ("G bwd", _g(NONCAUSAL, F32, True), "0.0801"),
    ("G bwd", _g(HD80, BF16, True), "0.2172"),
    ("G bwd", _g(HD80, F32, True), "3.2060"),
    ("I bwd", RS.bwd_work(1, 4096, 4096), "0.100172"),
    ("I bwd", RS.bwd_work(2, 512, 4096), "0.025060"),
]


@pytest.mark.parametrize("kernel,work,printed", PERF_BOUNDS,
                         ids=[f"{k}-{i}" for i, (k, _, _)
                              in enumerate(PERF_BOUNDS)])
def test_kernel_work_gives_the_perf_bound(kernel, work, printed):
    seconds, _ = OS.kernel_bound(work)
    decimals = len(printed.split(".")[1])
    assert f"{seconds * 1e3:.{decimals}f}" == printed


def test_kernel_bound_names_its_term():
    assert OS.kernel_bound(PW.work(4096, 4096, 512))[1] == "operations"
    assert OS.kernel_bound(RS.work(1, 4096, 4096))[1] == "bytes"
    g = _g(QWEN, BF16)
    assert (g.dtype, g.dot) == ("bf16", True)
    assert _g(QWEN, F32).dtype == "f32"


def _j_bytes(mesh, tree, specs) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape)))
               * x.dtype.itemsize for x, s in zip(leaves, spec_leaves))


def _reference_memory(arch, shape):
    """One device's argument and output bytes of the reference's step on
    an abstract (2, 4) mesh, from ``jax.eval_shape`` trees and the
    reference's spec tables."""
    cfg = j_get_config(arch).reduced()
    mesh = JM.make_abstract_mesh((2, 4), ("data", "model"))
    spec = JI.input_specs(cfg, INPUT_SHAPES[shape])
    params = jax.eval_shape(functools.partial(JT.init_params, cfg),
                            jax.random.key(0))
    psp = JS.param_specs(mesh, params)
    if spec.step_kind == "train":
        (batch,) = spec.args
        opt = jax.eval_shape(j_adamw_init, params)
        return _j_bytes(mesh, (params, opt, batch),
                        (psp, JS.param_specs(mesh, opt),
                         JS.batch_specs(mesh, batch))), None
    if spec.step_kind == "prefill":
        (batch,) = spec.args
        args, specs = (params, batch), (psp, JS.batch_specs(mesh, batch))
        logits, state = jax.eval_shape(
            lambda p, b: JT.prefill(cfg, p, b, window=spec.window), *args)
    else:
        state0, token = spec.args
        args = (params, state0, token)
        specs = (psp, JS.state_specs(mesh, state0),
                 JS.batch_specs(mesh, token))
        logits, state = jax.eval_shape(
            lambda p, s, t: JT.decode_step(cfg, p, s, t, window=spec.window,
                                           unroll=True), *args)
    out = _j_bytes(mesh, (logits, state),
                   (JS.logits_spec(mesh, *logits.shape, ndim=2),
                    JS.state_specs(mesh, state)))
    return _j_bytes(mesh, args, specs), out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b"])
def test_memory_record_matches_reference_shards(arch, shape):
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    want_args, want_out = _reference_memory(arch, shape)
    rec = lower_step(get_config(arch).reduced(), shape, mesh).memory
    assert rec["argument_size_in_bytes"] == want_args
    assert rec["temp_size_in_bytes"] is None
    if want_out is not None:
        assert rec["output_size_in_bytes"] == want_out
