"""The port's step lowering (``repro_torch.launch.lowering``): every
assigned config at full width on the single-pod layout, counted on
``meta``, against the reference's step kind, window, useful work and
parameter counts; the qwen1.5-0.5b prefill's products in closed form;
and the ``meta`` branches of the kernels.

The train steps of dbrx-132b, qwen3-moe-235b-a22b and recurrentgemma-9b
take 30-80 s each on ``meta`` here, and xlstm-125m's ``train_4k`` and
``prefill_32k`` run its sLSTM as one eager step per token (millions of
dispatched ops); those combinations are left to ``python -m
repro_torch.launch.dryrun --all``.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import hlo_stats as JH
from repro.launch import inputs as JI

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, InputShape
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as RS
from repro_torch.launch.inputs import ShapeSkip
from repro_torch.launch.lowering import analyze, lower_step
from repro_torch.launch.mesh import make_abstract_mesh
from _torch_threads import one_torch_thread  # noqa: F401

SLOW = {("dbrx-132b", "train_4k"), ("qwen3-moe-235b-a22b", "train_4k"),
        ("recurrentgemma-9b", "train_4k"), ("xlstm-125m", "train_4k"),
        ("xlstm-125m", "prefill_32k"),
        ("seamless-m4t-medium", "long_500k")}     # the skip: tested below
COMBOS = [(a, s) for a in ASSIGNED_ARCHS
          for s in ("prefill_32k", "decode_32k", "long_500k", "train_4k")
          if (a, s) not in SLOW]


@pytest.fixture(scope="module")
def single_pod():
    return make_abstract_mesh((16, 16), ("data", "model"))


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_lowered_step_matches_reference(single_pod, arch, shape):
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    ref = JI.input_specs(j_cfg, shape)
    rec = analyze(lower_step(cfg, shape, single_pod))
    s = INPUT_SHAPES[shape]
    assert (rec["step_kind"], rec["window"]) == (ref.step_kind, ref.window)
    assert rec["model_flops_total"] == JH.model_flops(
        j_cfg, ref.step_kind, s.global_batch, s.seq_len)
    assert rec["params_total"] == j_cfg.param_count()
    assert rec["params_active"] == j_cfg.active_param_count()
    assert rec["n_devices"] == 256 and rec["split"] == "even"
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["op_flops_per_device"] > 0 and rec["op_bytes_per_device"] > 0
    assert rec["collectives"]["ici_bytes"] == 0.0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    attn = any(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    kernel = {"train": "flash_attention_bwd", "prefill": "flash_attention",
              "decode": "decode_gqa"}[ref.step_kind]
    assert (kernel in rec["kernels"]) == attn


def test_long_500k_skip_is_honoured(single_pod):
    with pytest.raises(ShapeSkip, match="long_500k"):
        lower_step(get_config("seamless-m4t-medium"), "long_500k",
                   single_pod)


def _block_product_weights(cfg) -> int:
    d, H, KV, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    return d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * cfg.d_ff


def test_qwen_prefill_products_in_closed_form():
    cfg = get_config("qwen1.5-0.5b").reduced()
    B, S = 2, 128
    res = lower_step(cfg, InputShape("p", S, B, "prefill"),
                     make_abstract_mesh((1, 1), ("data", "model")))
    g = FA.work(B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                torch.float32)
    want = (2 * B * S * cfg.n_layers * _block_product_weights(cfg)
            + cfg.n_layers * g.ops
            + 2 * B * cfg.d_model * cfg.padded_vocab)   # last position only
    assert res.cost.dot_flops == want
    assert res.cost.kernels == {"flash_attention": cfg.n_layers}
    assert res.cost.items[("flash_attention", "kernel")] == [
        cfg.n_layers, cfg.n_layers * g.ops, cfg.n_layers * g.bytes]


def test_train_step_counts_the_backward_kernels():
    cfg = get_config("recurrentgemma-9b").reduced()
    res = lower_step(cfg, InputShape("t", 32, 2, "train"),
                     make_abstract_mesh((1, 1), ("data", "model")))
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn, n_rec = kinds.count("attn"), kinds.count("rec")
    k = res.cost.kernels
    assert k["flash_attention_bwd"] == n_attn * cfg.train_microbatches
    assert k["rglru_scan_bwd"] == n_rec * cfg.train_microbatches
    assert k["flash_attention"] >= n_attn and k["rglru_scan"] >= n_rec


def _rand(shape, dtype=torch.float32, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=shape).astype(np.float32)).to(dtype)


def _meta_cases():
    q, k, v = _rand((1, 40, 4, 16)), _rand((1, 40, 2, 16)), _rand(
        (1, 40, 2, 16))
    out, lse = FA.flash_attention_plain(q, k, v, return_lse=True)
    dout = _rand((1, 40, 4, 16), seed=1)
    kc, vc = _rand((2, 24, 2, 16), torch.bfloat16), _rand(
        (2, 24, 2, 16), torch.bfloat16)
    qd = _rand((2, 4, 16), torch.bfloat16)
    slot_pos = torch.arange(24, dtype=torch.int32).expand(2, 24)
    my_pos = torch.tensor([23, 11], dtype=torch.int32)
    a, b = torch.rand(2, 9, 8), _rand((2, 9, 8))
    h0 = _rand((2, 8))
    h, _ = RS.rglru_scan_plain(a, b, h0)
    return {
        "flash_attention": (ops.flash_attention, (q, k, v),
                            dict(causal=True, window=8)),
        "flash_attention_bwd": (ops.flash_attention_bwd,
                                (q, k, v, out, lse, dout), {}),
        "decode_gqa": (ops.decode_gqa, (qd, kc, vc, slot_pos, my_pos),
                       dict(round_p=True)),
        "rglru_scan": (ops.rglru_scan, (a, b, h0), {}),
        "rglru_scan_bwd": (ops.rglru_scan_bwd, (a, h0, h, b), {}),
    }


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd",
                                  "decode_gqa", "rglru_scan",
                                  "rglru_scan_bwd"])
def test_meta_branch_gives_the_plain_shapes(name):
    fn, args, kw = _meta_cases()[name]
    want = fn(*args, **kw)
    n0 = ops.launch_counts()
    got = fn(*(a.to("meta") for a in args), **kw)
    assert ops.launch_counts() == n0
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)


def test_meta_attention_takes_the_card_route():
    """Under autograd on ``meta``, G's forward and backward are the
    kernels' (the CPU differentiates the chunked plain attention)."""
    from repro_torch.launch.op_cost import count
    from repro_torch.models.attention import chunked_attention

    q = torch.empty((1, 64, 4, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 64, 2, 16), device="meta", requires_grad=True)
    v = torch.empty((1, 64, 2, 16), device="meta", requires_grad=True)

    def step(q, k, v):
        return torch.autograd.grad(chunked_attention(q, k, v).sum(),
                                   (q, k, v))

    grads, cost = count(step, q, k, v)
    assert cost.kernels == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
