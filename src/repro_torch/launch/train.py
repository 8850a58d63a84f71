"""Production training driver (port of :mod:`repro.launch.train`).

Runs the LM ``train_step`` for an assigned architecture on the CUDA card
(``--device cpu``: the CPU; ``--reduced`` for the smoke-scale variant).
``--mesh host`` (the default) is the 1 x 1 ``("data", "model")`` mesh of
that device: the parameter and AdamW specs are inferred from a shape-only
tree (``meta``) and the parameters placed by them, whole on the one
device.  ``--mesh single-pod`` / ``multi-pod`` need 256 / 512 cards and
exit 1 with :func:`repro_torch.launch.mesh.make_production_mesh`'s message
on a machine with fewer.  Parameters are drawn on the device from a
``torch.Generator`` seeded with ``--seed`` (no host copy of a
multi-billion-parameter model), data comes
from the deterministic synthetic LM stream, each step is
:func:`repro_torch.train.make_train_step` in the config's
``train_microbatches`` (activation checkpointing per ``remat_every``
periods), and checkpoints are written every ``--ckpt-every`` steps.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

``main(argv)`` returns what it printed as numbers: each logged step's
loss, aux and seconds since the previous logged step (the first is the
warm one), the parameter count and the checkpoints written; and the
trained parameters.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..data import make_lm_tokens
from ..models import transformer as tfm
from ..train import adamw_init, make_train_step, save_checkpoint
from ..train.optimizer import tree_leaves
from . import resolve_device
from . import sharding as shd
from .mesh import make_host_mesh, make_production_mesh


def build_mesh(kind: str, device):
    if kind == "host":
        return make_host_mesh(device)
    return make_production_mesh(multi_pod=(kind == "multi-pod"))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=("host", "single-pod", "multi-pod"),
                    default="host",
                    help="host: one device (the card, or the CPU under "
                         "--device cpu); single-pod / multi-pod: 256 / 512 "
                         "cards")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-path", default="experiments/ckpt/train")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, ap.prog)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    try:
        mesh = build_mesh(args.mesh, device)
    except ValueError as e:
        ap.exit(1, f"{ap.prog}: --mesh {args.mesh}: {e}\n")
    if mesh.size > 1:
        ap.exit(1, f"{ap.prog}: --mesh {args.mesh}: the step runs on one "
                   f"device; {mesh.size} need the model's tensor-parallel "
                   f"split\n")
    shapes = tfm.init_params(cfg, device="meta")
    psp = shd.param_specs(mesh, shapes)
    osp = shd.param_specs(mesh, adamw_init(shapes))
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    params = shd.blocks(shd.device_put(params, shd.named(mesh, psp)))[0]
    opt = shd.blocks(shd.device_put(adamw_init(params),
                                    shd.named(mesh, osp)))[0]
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"mesh={mesh.shape} device={device}")

    step_fn = make_train_step(cfg, lr=args.lr)

    tokens = make_lm_tokens(
        cfg.vocab, args.seq, args.batch * args.steps, seed=args.seed
    )
    frontend = None
    if cfg.is_encoder_decoder or cfg.n_frontend_tokens:
        nf = (cfg.n_enc_tokens if cfg.is_encoder_decoder
              else cfg.n_frontend_tokens)
        frontend = torch.from_numpy(np.random.default_rng(args.seed).normal(
            size=(args.batch, nf, cfg.d_model)
        ).astype(np.float32)).to(device)

    out = dict(n_params=n_params, steps=[], losses=[], aux=[], seconds=[],
               checkpoints=[])
    t0 = last = time.time()
    for step in range(args.steps):
        lo = step * args.batch
        batch = {"tokens": torch.from_numpy(
            tokens[lo:lo + args.batch]).to(device)}
        if frontend is not None:
            batch["frontend"] = frontend
        params, opt, metrics = step_fn(params, opt, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            aux = float(metrics["aux"])
            now = time.time()
            dt = now - t0
            tok_s = args.batch * args.seq * (step + 1) / max(dt, 1e-9)
            print(f"step {step:5d}  loss {loss:7.4f}  "
                  f"aux {aux:.4f}  "
                  f"tokens/s {tok_s:,.0f}")
            out["steps"].append(step)
            out["losses"].append(loss)
            out["aux"].append(aux)
            out["seconds"].append(now - last)
            last = now
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            path = f"{args.ckpt_path}_{step + 1}.npz"
            save_checkpoint(path, params)
            print(f"checkpoint -> {path}")
            out["checkpoints"].append(path)
    _sync(device)
    out["total_s"] = time.time() - t0
    print(f"done: {args.steps} steps in {out['total_s']:.1f}s")
    out["params"] = params
    return out


if __name__ == "__main__":
    main()
