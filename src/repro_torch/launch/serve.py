"""Serving driver (port of :mod:`repro.launch.serve`): Zygarde scheduling
over live models, small and large, on the CUDA card (``--device cpu``: the
CPU).

Two engines behind one CLI:

* ``--engine scalar`` (default) — the event-driven loop
  (:class:`repro_torch.serve.ServeEngine`): one or more classification
  tasks (agile CNNs trained by :func:`repro_torch.train.train_agile_cnn`),
  a calibrated energy harvester, and live unit-wise execution with early
  exit (kernel D), centroid adaptation (kernel E) and the zeta_I
  scheduler.  The vectorized fleet engine and its streams are driven by
  ``chip_smoke.py`` and the examples.
* ``--engine anytime`` — deadline-aware anytime serving of a registered
  big-model config at the reference's reduced size
  (:class:`repro_torch.serve.AnytimeServeEngine`): continuous batching
  over a decode loop (kernel H on an attention config; the engine decodes
  its prompts token by token, so kernel G does not run), per-request
  deadlines, early-exit depth control from the exit-head margins, and the
  Eq. 7 energy gate.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.serve --tasks mnist esc10 \\
        --policy zygarde --eta 0.71 --source solar --requests 40

    PYTHONPATH=src python -m repro_torch.launch.serve --engine anytime \\
        --arch xlstm-125m --policy zygarde --requests 24 --deadline 2.5

``main(argv)`` returns the result's ``as_dict()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..core import energy
from ..core.agile import AgileCNN
from ..data import make_dataset
from ..serve import Request, ServeConfig, ServeEngine
from ..train import train_agile_cnn
from . import resolve_device


def build_task(name: str, seed: int, device):
    ds = make_dataset(name, n_train=384, n_test=256, seed=seed)
    trained = train_agile_cnn(ds, epochs=3, n_pairs=768, seed=seed,
                              device=device)
    model = AgileCNN(trained.cfg, trained.params, trained.bank)
    return ds, model


def build_harvester(args):
    if args.source == "battery":
        return energy.Harvester("battery", 1.0, 0.0, 1.0), 1.0
    harv = energy.calibrate_harvester(args.eta, args.power,
                                      name=args.source)
    return harv, args.eta


def run_scalar(args, device) -> dict:
    harv, eta = build_harvester(args)
    models, request_streams = [], []
    for i, name in enumerate(args.tasks):
        print(f"training agile model for task {name!r} ...")
        ds, model = build_task(name, args.seed + i, device)
        models.append(model)
        request_streams.append([
            Request(ds.x_test[j], int(ds.y_test[j]),
                    release=j * args.period)
            for j in range(min(args.requests, len(ds.x_test)))
        ])

    n_units = max(m.n_units for m in models)
    engine = ServeEngine(
        models, harv, eta,
        config=ServeConfig(
            policy=args.policy, period=args.period,
            deadline=args.deadline,
            horizon=args.requests * args.period + 5.0,
            adapt=not args.no_adapt, seed=args.seed,
            unit_time=np.full(n_units, 0.25),
            unit_energy=np.full(n_units, 6e-3),
        ),
    )
    print(f"serving {sum(len(r) for r in request_streams)} requests "
          f"({len(models)} tasks) under {args.policy} on {args.source} "
          f"(eta={eta:.2f}) ...")
    res = engine.run(request_streams)
    out = res.as_dict()
    print(json.dumps(out, indent=2))
    sched_pct = 100 * res.scheduled / max(res.released, 1)
    corr_pct = 100 * res.correct / max(res.scheduled, 1)
    print(f"scheduled {res.scheduled}/{res.released} ({sched_pct:.0f}%), "
          f"{corr_pct:.0f}% of scheduled classified correctly")
    return out


def run_anytime(args, device) -> dict:
    from ..configs import get_config
    from ..models import transformer as T
    from ..serve import (AnytimeConfig, AnytimeRequest,
                         AnytimeServeEngine)

    # the reference's CPU-runnable variant of the registered config, deep
    # enough to have optional units worth skipping
    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(
        cfg, n_layers=max(cfg.n_layers, 4), vocab=min(cfg.vocab, 64),
        d_model=min(cfg.d_model, 128), exit_every=1)
    params = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    policy = {"zygarde": "anytime", "edf": "edf", "edf-m": "edf-m",
              "rr": "anytime"}[args.policy]
    # enough steps for the full release span: idle steps cost t_base
    span = args.requests * args.period + args.deadline + 1.0
    serve_cfg = AnytimeConfig(
        policy=policy, batch_slots=4,
        max_steps=int(span / 0.02) + 64, prompt_len=2,
        max_new_tokens=8)
    harv = None if args.source == "battery" else build_harvester(args)[0]
    engine = AnytimeServeEngine(cfg, params, serve_cfg=serve_cfg,
                                supply=harv, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = [
        AnytimeRequest(
            prompt=[int(rng.integers(0, cfg.vocab))], n_tokens=6,
            release=i * args.period,
            deadline=i * args.period + args.deadline)
        for i in range(args.requests)
    ]
    print(f"anytime-serving {len(reqs)} requests on {args.arch} "
          f"({cfg.n_units} units, policy {policy!r}, "
          f"source {args.source}) ...")
    res = engine.run(reqs)
    out = res.as_dict()
    print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Zygarde serving driver (scalar agile engine or "
                    "anytime big-model engine)")
    ap.add_argument("--engine", default="scalar",
                    choices=["scalar", "anytime"])
    ap.add_argument("--tasks", nargs="+", default=["mnist"],
                    choices=["mnist", "esc10", "cifar100", "vww"])
    ap.add_argument("--arch", default="xlstm-125m",
                    help="registered model config for --engine anytime")
    ap.add_argument("--policy", default="zygarde",
                    choices=["zygarde", "edf", "edf-m", "rr"])
    ap.add_argument("--eta", type=float, default=0.71)
    ap.add_argument("--source", default="solar",
                    choices=["battery", "solar", "rf"])
    ap.add_argument("--power", type=float, default=0.3)
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--period", type=float, default=1.0)
    ap.add_argument("--deadline", type=float, default=2.0)
    ap.add_argument("--no-adapt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, ap.prog)
    if args.engine == "anytime":
        return run_anytime(args, device)
    return run_scalar(args, device)


if __name__ == "__main__":
    main()
