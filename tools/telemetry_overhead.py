"""What telemetry costs per step on the card, each tier against plain.

    PYTHONPATH=src python tools/telemetry_overhead.py [--steps 232] [--turns 2]

The workloads are ``chip_smoke.py``'s: the replay sweep's 1,600 devices
(the two §9.2 models' job profiles) over its first ``--steps`` steps in the
``vmap`` and ``pallas`` modes, and the §9.2 serve scan with adaptation on a
per-device bank (64 devices, its whole 545-step horizon from the built
state).  Each is run at every tier in turns, plain / counters / full /
full / counters / plain,
``--turns`` times, so that a drift of the host's speed within the call
falls on every tier alike; each run's host-clock time ends in a device
synchronisation.  Prints per tier the median ms per step with the smallest
and largest run, the median's ratio to plain, and the kernel launches per
step that ``torch.profiler`` counts over 10 steps.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

TIERS = ("plain", "counters", "full")


def _launches_per_step(run, n: int = 10) -> float:
    """Kernel launches per step that the profiler sees over ``run(n)``."""
    from torch.profiler import ProfilerActivity, profile

    run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in kernels) / n


def _turns(run, steps: int, turns: int) -> dict:
    """ms per step of each tier over ``turns`` rounds of plain, counters,
    full, full, counters, plain."""
    times = {t: [] for t in TIERS}
    order = TIERS + TIERS[::-1]
    for _ in range(turns):
        for tier in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(tier)
            torch.cuda.synchronize()
            times[tier].append(1e3 * (time.perf_counter() - t0) / steps)
    return times


def _report(label: str, times: dict, launches: dict) -> None:
    base = float(np.median(times["plain"]))
    for tier in TIERS:
        ts = times[tier]
        med = float(np.median(ts))
        print(f"{label} {tier}: {med:.3f} ms per step (runs "
              f"{min(ts):.3f}-{max(ts):.3f}, n={len(ts)}), "
              f"{100 * (med / base - 1):+.1f}% against plain; "
              f"{launches[tier]:.1f} launches per step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=232,
                    help="replay steps per timed run")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("telemetry_overhead: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import telemetry as TEL
    from repro_torch.fleet import build, run_segments

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke._card_line())
    scale = chip_smoke.FULL
    tiers = {"plain": None,
             "counters": TEL.TelemetryConfig(ring_size=256,
                                             level="counters"),
             "full": TEL.TelemetryConfig(ring_size=256, level="full")}
    models, sets = chip_smoke._models(dev, scale)

    tasks = chip_smoke._replay_tasks(models, sets, scale)
    cfg, statics, meta = build(chip_smoke._replay_grid(tasks, scale,
                                                       scale.seeds), dev)
    st = chip_smoke._steps(statics, args.steps)
    for mode in ("vmap", "pallas"):
        def replay(tier, k=None, mode=mode):
            return run_segments(cfg, st if k is None
                                else chip_smoke._steps(statics, k), 1,
                                mode=mode, telemetry=tiers[tier])

        replay("full", 3)                                 # warm-up
        times = _turns(replay, args.steps, args.turns)
        launches = {t: _launches_per_step(lambda k, t=t: replay(t, k))
                    for t in TIERS}
        _report(f"replay {mode} (D={len(meta)}, {args.steps} steps)", times,
                launches)

    eng = chip_smoke._serve_engine(dev, scale, models, True, "per-device")
    requests = chip_smoke._serve_requests(scale, sets)
    seeds = list(range(scale.n_devices))
    cfg_s, st_s, tables, carry0, _ = eng.build(requests, scale.n_devices,
                                               seeds=seeds)

    def serve_steps(tier, k=st_s.n_steps):
        """The serve loop from the built state (``run`` without its
        feature build), with the full tier's host fold."""
        tcfg = tiers[tier]
        tel = None if tcfg is None else TEL.init_fleet_telemetry(tcfg,
                                                                 cfg_s)
        return eng._scan_steps(cfg_s, tables, carry0, 0, statics=st_s,
                               n_steps=k, adapt=True, tel=tel, tcfg=tcfg)

    serve_steps("full", 3)                                # warm-up
    times = _turns(serve_steps, st_s.n_steps, args.turns)
    launches = {t: _launches_per_step(lambda k, t=t: serve_steps(t, k))
                for t in TIERS}
    _report(f"serve scan adapt per-device (D={scale.n_devices}, "
            f"{st_s.n_steps} steps)", times, launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
