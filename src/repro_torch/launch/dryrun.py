"""Multi-pod dry run (port of :mod:`repro.launch.dryrun`).

Counts the step every (architecture x input shape) pair dictates —
``train_step`` for train_4k, ``prefill`` for prefill_32k, ``decode_step``
(one token against a seq_len cache) for decode_32k / long_500k — on
``meta`` (:func:`repro_torch.launch.lowering.lower_step`) for the
production layouts:

    single-pod : 16 x 16           ("data", "model")        = 256 cards
    multi-pod  : 2 x 16 x 16       ("pod", "data", "model") = 512 cards

as abstract meshes (the counterpart of the reference's 512 forced host
devices: ``make_production_mesh`` still needs the cards), and records one
device's memory, the op cost, the collectives and the three roofline
terms on the H100 into a JSON record per combination.  Nothing touches a
device.

Usage:
    python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k
    python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k \\
        --multi-pod
    python -m repro_torch.launch.dryrun --all --out-dir experiments/dryrun
"""
import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path


def production_layout(multi_pod: bool):
    """The abstract production mesh: 16 x 16, or 2 x 16 x 16."""
    from repro_torch.launch.mesh import make_abstract_mesh

    if multi_pod:
        return make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_abstract_mesh((16, 16), ("data", "model"))


def run_one(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import ShapeSkip
    from repro_torch.launch.lowering import analyze, lower_step

    cfg = get_config(arch)
    mesh = production_layout(multi_pod)
    t0 = time.time()
    try:
        result = lower_step(cfg, shape, mesh)
    except ShapeSkip as e:
        return {
            "arch": arch, "shape": shape,
            "mesh": list(mesh.shape.values()), "status": "skip",
            "reason": str(e),
        }
    record = analyze(result)
    record["status"] = "ok"
    record["compile_s"] = round(time.time() - t0, 1)
    return record


def combo_list():
    from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES

    return [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]


def sweep(out_dir: Path, multi_pod: bool, jobs: int, archs=None,
          shapes=None) -> int:
    """Run every combination in subprocesses (isolation + parallelism)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    combos = [
        (a, s) for a, s in combo_list()
        if (archs is None or a in archs) and (shapes is None or s in shapes)
    ]
    pending = list(combos)
    running: list[tuple] = []
    failures = 0
    while pending or running:
        while pending and len(running) < jobs:
            arch, shape = pending.pop(0)
            tag = f"{arch}__{shape}" + ("__multipod" if multi_pod else "")
            out = out_dir / f"{tag}.json"
            if out.exists():
                print(f"[skip-existing] {tag}")
                continue
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--out", str(out),
            ]
            if multi_pod:
                cmd.append("--multi-pod")
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            running.append((proc, tag, out, time.time()))
        done = [r for r in running if r[0].poll() is not None]
        for proc, tag, out, t0 in done:
            running.remove((proc, tag, out, t0))
            dt = time.time() - t0
            log = proc.stdout.read() if proc.stdout else ""
            if proc.returncode == 0 and out.exists():
                rec = json.loads(out.read_text())
                r = rec.get("roofline", {})
                print(
                    f"[{rec['status']:>4}] {tag} ({dt:.0f}s) "
                    f"dom={r.get('dominant', '-')}"
                )
            else:
                failures += 1
                (out_dir / f"{tag}.err").write_text(log)
                print(f"[FAIL] {tag} ({dt:.0f}s) -> {out_dir / tag}.err")
        time.sleep(0.2)
    return failures


def main(argv=None) -> dict:
    """The CLI; in process, the single combination's record."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", nargs="*", help="subset filter for --all")
    ap.add_argument("--shapes", nargs="*", help="subset filter for --all")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", help="JSON output path (single combo)")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        n_fail = sweep(
            Path(args.out_dir), args.multi_pod, args.jobs,
            archs=args.archs, shapes=args.shapes,
        )
        sys.exit(1 if n_fail else 0)

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    try:
        record = run_one(args.arch, args.shape, args.multi_pod)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    text = json.dumps(record, indent=2)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return record


if __name__ == "__main__":
    main()
