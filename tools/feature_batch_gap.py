"""How far a request's unit features move with the batch they are
computed in, for the §9.2 agile CNNs of ``chip_smoke.py`` on the card.

    PYTHONPATH=src python tools/feature_batch_gap.py

For each task: the unit features of its 25 base requests computed in one
batch of 25 (what ``FleetServeEngine.build_stream`` does for the stream),
inside one batch of 123 requests that cycles them (what ``run`` does over
the repeated list) and one request at a time (``feature_batch=1``).  Prints
per unit the largest absolute gap and the count of differing values
between the batch-25 features and each other way, and the same for the
classification margins against the fitted bank.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import kmeans as km  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("feature_batch_gap: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(chip_smoke._card_line())
    models, sets = chip_smoke._models(dev, chip_smoke.FULL)
    n, total = chip_smoke.FULL.n_requests, chip_smoke.FULL.stream_jobs
    for m, ds in zip(models, sets):
        xs = ds.x_test[:n]
        cyc = np.stack([xs[j % n] for j in range(total)])
        base = m.unit_features(xs)
        ways = {f"in a batch of {total}": [f[:n] for f in
                                            m.unit_features(cyc)],
                "one at a time": m.unit_features(xs, batch_size=1)}
        for label, other in ways.items():
            for u, (a, b) in enumerate(zip(base, other)):
                ma, mb = (km.classify(m.bank[u], torch.from_numpy(f).to(
                    dev))[4].cpu().numpy() for f in (a, b))
                print(f"{m.cfg.name} unit {u} ({a.shape[1]} features), "
                      f"batch {n} vs {label}: features max gap "
                      f"{np.abs(a - b).max():.3g} ({int((a != b).sum())} of "
                      f"{a.size} differ), margins max gap "
                      f"{np.abs(ma - mb).max():.3g} "
                      f"({int((ma != mb).sum())} of {ma.size} differ)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
