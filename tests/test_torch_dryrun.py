"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``): one
combination at the single-pod and multi-pod layouts, the documented skip,
and ``--all`` filtered to one combination (each in a subprocess of its
own)."""
import json
import subprocess
import sys

from _subproc import sub_env

from repro_torch.launch import dryrun
from _torch_threads import one_torch_thread  # noqa: F401


def run_module(args, timeout=300):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun"] + args,
        capture_output=True, text=True, timeout=timeout, env=sub_env(),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_dryrun_cli_single_combo(tmp_path):
    out_file = tmp_path / "rec.json"
    run_module(["--arch", "xlstm-125m", "--shape", "decode_32k",
                "--out", str(out_file)])
    rec = json.loads(out_file.read_text())
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 256 and rec["mesh"] == [16, 16]
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["temp_size_in_bytes"] is None


def test_dryrun_multi_pod(capsys):
    rec = dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k",
                       "--multi-pod"])
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512
    assert rec["mesh_axes"] == ["pod", "data", "model"]
    assert json.loads(capsys.readouterr().out) == rec


def test_dryrun_skip_record(tmp_path):
    out_file = tmp_path / "skip.json"
    rec = dryrun.main(["--arch", "seamless-m4t-medium", "--shape",
                       "long_500k", "--out", str(out_file)])
    assert rec["status"] == "skip" and "long_500k" in rec["reason"]
    assert json.loads(out_file.read_text()) == rec


def test_dryrun_all_filtered(tmp_path):
    out = run_module(["--all", "--archs", "xlstm-125m", "--shapes",
                      "decode_32k", "--out-dir", str(tmp_path)])
    assert "[  ok] xlstm-125m__decode_32k" in out
    assert [p.name for p in tmp_path.iterdir()] == [
        "xlstm-125m__decode_32k.json"]
