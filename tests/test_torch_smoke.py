"""Isolation of the PyTorch port and the contract of ``chip_smoke.py``.

The port (``src/repro_torch``) and ``chip_smoke.py`` must import neither
JAX nor the JAX package ``repro``; fresh interpreters check it.  Without a
CUDA card ``chip_smoke.py`` must fail and print no result, also when it
sits alone in a directory.  Its phases are rehearsed here on the CPU at
narrow widths with the kernels' plain versions.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ROOT / "chip_smoke.py"

_CHECK = """
import sys
bad = [m for m in sys.modules
       if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
print("clean")
"""


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
""" + _CHECK
    r = _run(code)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def _smoke_imports():
    """Every module chip_smoke.py imports, at top level or in a function."""
    names = set()
    for node in ast.walk(ast.parse(SMOKE.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return sorted(names)


def test_chip_smoke_imports_no_jax():
    names = _smoke_imports()
    assert not [n for n in names if n.split(".")[0] in ("jax", "repro")]
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import importlib, chip_smoke\n"
            f"for n in {names!r}: importlib.import_module(n)\n" + _CHECK)
    r = _run(code)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_rehearsal_on_cpu():
    """Every phase at narrow widths on the CPU — serving, the scalar
    engine, scalar == fleet, the intermittent substrate, the stream, the
    replay sweep, kernel F, offline tuning, online adaptation with the
    fleet forecast arm, telemetry on the replay sweep and the serve scan,
    anytime serving of the dense model with kernel G's checks, of the
    RG-LRU hybrid with kernel H's and I's, and of the rest of the model
    zoo (MoE, xLSTM, the encoder-decoder, the VLM), and training (the
    agile CNNs, the LM step of the dense model and the hybrid, the
    backward kernels of G and I), the launch drivers, the mesh entry
    points and the serve engines over meshes of several blocks: the
    kernels report names A to I, the two backward kernels and the slice
    entries of E and H with the contract's keys (no launches on the CPU),
    each with the paths that ran it."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    report = chip_smoke._rehearse("cpu")
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    rows = report["kernels"]
    assert [r["name"] for r in rows] == [
        "fleet_priority", "fleet_fused_steps", "serve_fused_steps",
        "l1_topk2", "centroid_update", "pairwise_l1", "flash_attention",
        "decode_gqa", "rglru_scan", "flash_attention_bwd", "rglru_scan_bwd",
        "centroid_partial", "centroid_finish", "decode_gqa_stats",
        "decode_gqa_merge", "decode_gqa_pv"]
    paths = {r["name"]: sorted(r["launches_by_path"]) for r in rows}
    assert paths["fleet_fused_steps"] == ["mesh", "online", "replay", "tune"]
    assert paths["pairwise_l1"] == ["online"]
    serving = ["anytime", "dbrx-132b", "hybrid", "internvl2-2b",
               "qwen3-moe-235b-a22b", "seamless-m4t-medium"]
    training = ["launch train", "train qwen1.5-0.5b",
                "train recurrentgemma-9b"]
    assert paths["decode_gqa"] == sorted(serving + ["launch serve anytime",
                                                    "mesh", "mesh anytime"])
    assert paths["flash_attention"] == sorted(serving + training + ["mesh"])
    assert paths["flash_attention_bwd"] == sorted(training + ["mesh"])
    assert paths["rglru_scan"] == ["hybrid", "train recurrentgemma-9b"]
    assert paths["rglru_scan_bwd"] == ["train recurrentgemma-9b"]
    assert paths["serve_fused_steps"] == ["serve", "stream"]
    assert paths["centroid_update"] == [
        "launch serve scalar", "mesh", "online", "scalar", "serve", "stream",
        "telemetry"]
    assert paths["l1_topk2"] == sorted(paths["centroid_update"]
                                       + ["mesh serve", "train_cnn"])
    for name in ("centroid_partial", "centroid_finish"):
        assert paths[name] == ["mesh serve"]
    for name in ("decode_gqa_stats", "decode_gqa_merge", "decode_gqa_pv"):
        assert paths[name] == ["mesh anytime"]
    assert paths["fleet_priority"] == ["mesh", "replay", "telemetry"]
    for r in rows:
        assert keys <= set(r)
        assert r["launches"] == 0 and r["max_abs_err"] == 0.0
        assert (ROOT / r["source"]).exists()
        path, line = r["replaces"].split(":")
        assert "pallas_call" in (ROOT / path).read_text() and int(line) > 0
