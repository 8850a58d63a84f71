"""Phase 3a's two host-clock rates, in turns, in one process.

The fleet's live rate (``FleetServeEngine.run``, scan mode with adaptation
on a per-device bank, 64 devices) and the scalar ``ServeEngine``'s rate
under zygarde, both on ``chip_smoke.py``'s §9.2 workload at Table-3
widths, each timed twice and three times per block; then one
``torch.profiler`` session (as phase 2 runs before phase 3) and two more
blocks.  Prints each block's rates and the host time of one small launch.

    PYTHONPATH=src python tools/serve_rates.py     (needs a CUDA card)
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import l1_topk2 as L1  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


def main() -> None:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sc = cs.FULL
    models, sets = cs._models(dev, sc)
    reqs = cs._serve_requests(sc, sets)
    seeds = list(range(sc.n_devices))

    def launch_us(n=20000):
        x = torch.zeros(16, device=dev)
        for _ in range(200):
            x.add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    def fleet():
        return cs._serve_engine(dev, sc, models, True, "per-device").run(
            reqs, sc.n_devices, seeds=seeds, n_segments=sc.n_segments,
            mode="scan").jobs_per_sec

    def scalar():
        cfg = cs._serve_config(models, "zygarde", True, sc.n_requests)
        eng = ServeEngine(cs._fresh(models), cs._solar(), eta=0.71,
                          config=cfg)
        r, secs = cs._timed(lambda: eng.run(reqs), dev)
        return r.released / secs

    def block(tag):
        lu = launch_us()
        f = [fleet() for _ in range(2)]
        s = [scalar() for _ in range(3)]
        print(f"{tag}: one add_ {lu:.2f} us; fleet "
              f"{', '.join(f'{v:.1f}' for v in f)} jobs/s; scalar "
              f"{', '.join(f'{v:.1f}' for v in s)} jobs/s", flush=True)

    fleet()                                                 # warm-up
    scalar()
    block("before any profiler")
    x = torch.randn(64, 150, device=dev)
    c = torch.randn(64, 5, 150, device=dev)
    cs._kernel_ms(lambda: L1.l1_topk2(x, c), dev, "l1_topk2_kernel")
    block("after one profiler session")
    block("again")


if __name__ == "__main__":
    main()
