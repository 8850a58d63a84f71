"""The port's profiling harness (``repro_torch.launch.profiling``) on the
CPU: the timing split, the roofline join and the trace context."""
import json

import pytest
import torch

from repro_torch.launch import op_stats as OS
from repro_torch.launch import profiling as PR
from _torch_threads import one_torch_thread  # noqa: F401


def test_measure_orders_its_times():
    x = torch.randn(64, 64)
    m = PR.measure(torch.matmul, x, x, label="mm", repeats=7, warmup=1)
    assert m.label == "mm" and m.repeats == 7
    assert 0 < m.steady_min_s <= m.steady_s <= m.steady_max_s
    assert m.compile_s > 0 and m.roofline is None
    row = m.as_row()
    assert row["repeats"] == 7 and "_call" not in row
    assert "peak_bytes" not in m.extra       # no card: no device memory


def test_roofline_join_on_a_matmul():
    M, K, N = 48, 64, 32
    a, b = torch.randn(M, K), torch.randn(K, N)
    m = PR.profile_call(torch.matmul, a, b, repeats=3)
    r = m.roofline
    assert r["flops"] == r["dot_flops"] == 2 * M * K * N
    assert r["dot_flops_by_dtype"] == {"f32": 2 * M * K * N}
    assert r["bytes"] == 4 * (M * K + K * N + M * N)
    terms = OS.roofline_terms(flops=r["flops"], bytes_accessed=r["bytes"],
                              ici_bytes=0.0)
    assert r["bound_s"] == max(terms["compute_s"], terms["memory_s"],
                               terms["collective_s"])
    assert r["dominant"] == terms["dominant"] == "memory"
    assert r["measured_over_bound"] == pytest.approx(m.steady_s
                                                     / r["bound_s"])
    assert m.cost.items[("mm", "f32[48,32]")][0] == 1
    assert m.as_row()["roofline_flops"] == r["flops"]


def test_trace_disabled_is_a_no_op(tmp_path):
    with PR.trace(tmp_path, enabled=False) as path:
        torch.ones(3).sum()
    assert path is None
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with PR.trace(tmp_path / "t") as path:
        torch.tanh(torch.ones(8, 8)).sum()
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert path == str(tmp_path / "t" / "trace.json")
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::tanh" in names
