"""The port's op counter (``repro_torch.launch.op_cost``) against the
reference's loop-aware HLO cost model (``repro.launch.hlo_cost``) on the
cases of ``tests/test_hlo_cost.py``: the product flops of both equal the
closed form on the same shapes.  Also: views cost nothing, a call counts
the same on the CPU and on ``meta``, and a kernel counts as one item of
its ``work()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import HloCostModel

from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ops
from repro_torch.launch import op_cost as OC
from _torch_threads import one_torch_thread  # noqa: F401


def ref_cost(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return HloCostModel(
        jax.jit(fn).lower(*args).compile().as_text()).entry_cost()


def port_cost(fn, *shapes, device="cpu"):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device) for s in shapes]
    return OC.count(fn, *args)[1]


def j_scan(T):
    def f(x, w):
        def body(x, _):
            return jnp.tanh(x @ w), None

        y, _ = jax.lax.scan(body, x, None, length=T)
        return y

    return f


def t_loop(T):
    def f(x, w):
        for _ in range(T):
            x = torch.tanh(x @ w)
        return x

    return f


def j_nested(x, w):
    def inner(x, _):
        return x @ w, None

    def outer(x, _):
        y, _ = jax.lax.scan(inner, x, None, length=3)
        return y, None

    y, _ = jax.lax.scan(outer, x, None, length=5)
    return y


def t_nested(x, w):
    for _ in range(5):
        for _ in range(3):
            x = x @ w
    return x


CASES = {
    # name: (reference fn, port fn, shapes, closed-form product flops)
    "matmul": (lambda x, w: x @ w, lambda x, w: x @ w,
               ((64, 128), (128, 32)), 2 * 64 * 128 * 32),
    "scan": (j_scan(10), t_loop(10), ((32, 64), (64, 64)),
             2 * 32 * 64 * 64 * 10),
    "nested": (j_nested, t_nested, ((8, 16), (16, 16)),
               2 * 8 * 16 * 16 * 15),
    "einsum": (lambda x, w: jnp.einsum("bmk,bkn->bmn", x, w),
               lambda x, w: torch.einsum("bmk,bkn->bmn", x, w),
               ((4, 16, 32), (4, 32, 8)), 2 * 4 * 16 * 32 * 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dot_flops_match_reference(case):
    j_fn, t_fn, shapes, want = CASES[case]
    ref, port = ref_cost(j_fn, *shapes), port_cost(t_fn, *shapes)
    assert ref.dot_flops == pytest.approx(want, rel=1e-6)
    assert port.dot_flops == want == ref.dot_flops
    assert port.dot_flops_by_dtype == {"f32": want}


def test_scan_loop_adds_little_besides_the_products():
    want = 2 * 32 * 64 * 64 * 10
    cost = port_cost(t_loop(10), (32, 64), (64, 64))
    assert cost.flops == want + 10 * 32 * 64    # one flop per tanh output
    assert cost.flops < want * 1.1


def test_bytes_scale_with_trips():
    b1 = port_cost(t_loop(2), (64, 64), (64, 64)).bytes
    b2 = port_cost(t_loop(20), (64, 64), (64, 64)).bytes
    assert b2 == 10 * b1


def test_elementwise_flops_counted():
    cost = port_cost(lambda x: torch.tanh(x) * 2.0 + 1.0, (128, 128))
    assert cost.dot_flops == 0
    assert cost.flops >= 128 * 128
    assert cost.flops == 3 * 128 * 128


def test_analyze_dict_keys():
    d = OC.analyze(lambda x: x + 1.0, torch.ones(4, 4))
    for k in ("flops", "dot_flops", "bytes", "ici_bytes", "coll_counts",
              "coll_bytes"):
        assert k in d
    assert d["ici_bytes"] == 0.0         # one device: no collectives
    assert d["bytes"] == 2 * 4 * 4 * 4   # read x, write the sum


def test_views_cost_nothing():
    def views(x):
        y = x.view(8, 8).transpose(0, 1)[2:5].unsqueeze(0).expand(3, 3, 8)
        return x.reshape(4, 16)[:, ::2], y.detach(), x.t()

    cost = port_cost(views, (16, 4))
    assert (cost.flops, cost.bytes, cost.items) == (0.0, 0.0, {})


def test_copies_and_casts_count_their_bytes():
    cost = port_cost(lambda x: x.to(torch.bfloat16).t().contiguous(),
                     (32, 16))
    # the cast reads 4 and writes 2 bytes an element, the copy 2 and 2
    assert cost.bytes == 32 * 16 * (4 + 2) + 32 * 16 * (2 + 2)
    assert cost.flops == 0


def test_backward_products_counted():
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)

    def step(x, w):
        return torch.autograd.grad((x @ w).sum(), (x, w))

    cost = OC.count(step, x, w)[1]
    # the forward product and the two of its backward
    assert cost.dot_flops == 3 * 2 * 8 * 16 * 4


def test_cpu_and_meta_count_alike():
    def fn(x, w, b):
        h = torch.nn.functional.silu(torch.einsum("bsd,df->bsf", x, w) + b)
        return torch.softmax(h.to(torch.bfloat16).float(), -1).sum(-1)

    shapes = ((2, 8, 16), (16, 32), (32,))
    cpu, meta = port_cost(fn, *shapes), port_cost(fn, *shapes,
                                                   device="meta")
    assert cpu.as_dict() == meta.as_dict()
    assert cpu.items == meta.items


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48)])
def test_flash_attention_is_one_item_of_its_work(causal, window):
    rng = np.random.default_rng(1)
    B, S, Skv, H, KV, hd = 2, 96, 96, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, S, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    n0 = ops.launch_counts()
    for dev in ("cpu", "meta"):
        out, cost = OC.count(ops.flash_attention, q.to(dev), k.to(dev),
                             v.to(dev), causal=causal, window=window)
        w = FA.work(B, S, Skv, H, KV, hd, torch.float32, causal=causal,
                    window=window)
        assert cost.items == {("flash_attention", "kernel"):
                              [1, w.ops, w.bytes]}
        assert (cost.flops, cost.dot_flops, cost.bytes) == (w.ops, w.ops,
                                                            w.bytes)
        assert cost.kernels == {"flash_attention": 1}
        assert out.shape == (B, S, H, hd) and out.dtype == torch.float32
    assert ops.launch_counts() == n0


def test_top_cost_items_order_and_mult():
    def fn(x, w):
        for _ in range(3):
            x = x @ w
        return torch.tanh(x)

    cost = port_cost(fn, (16, 32), (32, 32))
    top = OC.top_cost_items(cost, n=5, by="flops")
    assert top[0]["op"] == "mm" and top[0]["mult"] == 3
    assert top[0]["flops"] == 3 * 2 * 16 * 32 * 32
    assert [r["op"] for r in top] == ["mm", "tanh"]
    assert OC.top_cost_items(cost, n=1, by="bytes")[0]["op"] == "mm"


def test_collectives_take_the_ring_factors():
    """``_c10d_functional`` collectives on a one-process gloo group: the
    group size an op names (all-gather) or the counter's device count
    (all-reduce names none), priced by the reference's ring factors."""
    import socket

    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        def step(x):
            y = fc.all_reduce(x, "sum", dist.group.WORLD)
            z = fc.all_gather_single(x, 0, dist.group.WORLD)
            return fc.wait_tensor(y), fc.wait_tensor(z)

        _, cost = OC.count(step, torch.ones(16, 4), n_devices=8)
    finally:
        dist.destroy_process_group()
    size = 16 * 4 * 4
    assert cost.collectives == [("all_reduce", size, 8),
                                ("all_gather_into_tensor", size, 1)]
    assert cost.coll_counts == {"all-reduce": 1, "all-gather": 1}
    assert cost.ici_bytes == 2.0 * size * 7 / 8
    assert OC.analyze(lambda x: x * 2, torch.ones(3))["ici_bytes"] == 0.0
