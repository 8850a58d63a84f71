"""Time one AdamW update on the card over a model's whole parameter tree.

    PYTHONPATH=src python tools/adamw_update_time.py [--arch qwen1.5-0.5b] \
        [--layers N] [--reps 3]

Builds the config's parameters at published widths in its own dtype
(``--layers`` cuts the depth, as ``chip_smoke.py``'s phase 11c cuts
recurrentgemma-9b to 3 layers), a zero AdamW state and a gradient tree of
the same shapes and dtypes, runs one update to warm up, then times
``--reps`` calls of ``repro_torch.train.adamw_update`` with CUDA events.
Prints one JSON line: the arch, its parameter count, the card's name and
power limit, and the ms of each timed update.  ``repro_torch`` is imported
from ``PYTHONPATH``, so that one call can time two source trees, each in a
process of its own.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("adamw_update_time: needs a CUDA card")

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import adamw_init, adamw_update
    from repro_torch.train.optimizer import tree_leaves, tree_map

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = adamw_init(params)
    grads = tree_map(lambda p: torch.full_like(p, 1e-4), params)
    params, opt = adamw_update(params, grads, opt)
    ms = []
    for _ in range(args.reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        e0.record()
        params, opt = adamw_update(params, grads, opt)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(json.dumps(dict(
        arch=args.arch, n_layers=cfg.n_layers,
        n_params=sum(p.numel() for p in tree_leaves(params)),
        source=repro_torch.__file__, card=card[0] if card else None,
        update_ms=ms)))


if __name__ == "__main__":
    main()
