"""Per-layer witness of the RG-LRU hybrid's drift from the JAX reference.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/hybrid_layer_witness.py \
        [--layers 13] [--seq 16] [--seed 0]

recurrentgemma-9b's ``reduced()`` config cut to ``--layers`` layers (f32),
the reference's random weights carried into the port
(``convert.transformer_params``).  The reference's ``forward`` scans its
periods in compiled groups of ``remat_every`` and runs the rest op by op;
this script repeats that program with one change, a per-layer output of
the scan, and checks that its logits equal the reference ``forward``'s bit
for bit, so the dump is the reference's own activations.  Then, for every
layer n, it feeds the reference's input to layer n into

* the port's layer n (``scanned`` where the reference compiles it), and
* the reference's own layer n run op by op (``jax.disable_jit()``),

and prints each one's largest gap to the reference's output of layer n, as
an absolute value and as a multiple of the tests' tolerance (rtol = atol =
1e-5: ``|a - b| / (1e-5 + 1e-5 |b|)``), beside the end-to-end gaps of the
logits.  Each layer's gap is its own arithmetic only; the end-to-end gap
is those gaps carried through the depth.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import transformer as PT

RTOL = ATOL = 1e-5


def ratio(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (ATOL + RTOL * np.abs(b))).max())


def gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def reference_dump(cfg, params, tokens):
    """The reference's ``forward`` (``remat=True``) with the input of every
    layer recorded: the same scan over groups of ``remat_every`` periods,
    each group checkpointed, whose body also returns the group's layer
    inputs.  Returns (logits, [x_0, ..., x_L]): x_n is the input of layer n
    and x_L the stack's output."""
    period, n_scan, rem_kinds = JT._layer_plan(cfg)
    stack = params["layers"]["stack"]
    k = max(1, cfg.remat_every)
    n_groups, leftover = divmod(n_scan, k)

    def apply_periods(x, bps):
        xs = []
        for j in range(jax.tree.leaves(bps[0])[0].shape[0]):
            for q in range(period):
                bp = jax.tree.map(lambda a, j=j: a[j], bps[q])
                xs.append(x)
                x, _, _ = JT.block_seq(bp, cfg, cfg.layer_kind(q), x)
        return x, jnp.stack(xs)

    group_fn = jax.checkpoint(apply_periods, prevent_cse=False)
    x = JT._embed(cfg, params, tokens)
    inputs = []
    if n_groups:
        grouped = tuple(jax.tree.map(
            lambda a: a[:n_groups * k].reshape(n_groups, k, *a.shape[1:]),
            stack[q]) for q in range(period))
        x, ys = jax.lax.scan(group_fn, x, grouped)
        inputs += [ys[g, i] for g in range(n_groups)
                   for i in range(ys.shape[1])]
    if leftover:
        tail = tuple(jax.tree.map(lambda a: a[n_groups * k:], stack[q])
                     for q in range(period))
        x, ys = group_fn(x, tail)
        inputs += list(ys)
    for bp, kind in zip(params["layers"]["rem"], rem_kinds):
        inputs.append(x)
        x, _, _ = JT.block_seq(bp, cfg, kind, x)
    inputs.append(x)
    return JT._readout(cfg, params, x), inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=13)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    arch = "recurrentgemma-9b"
    jcfg = jget(arch).reduced()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "n_layers": args.layers})
    pcfg = get_config(arch).reduced()
    pcfg = type(pcfg)(**{**pcfg.__dict__, "n_layers": args.layers})
    jp = JT.init_params(jcfg, jax.random.PRNGKey(args.seed))
    tp = convert.transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(args.seed).integers(
        0, jcfg.vocab, (2, args.seq)).astype(np.int32)

    want = np.asarray(JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})[0])
    logits, xs = reference_dump(jcfg, jp, jnp.asarray(toks))
    same = np.array_equal(np.asarray(logits), want)
    print(f"{arch} reduced, {args.layers} layers, 2 x {args.seq} tokens, "
          f"f32; the dump's logits equal the reference forward's bit for "
          f"bit: {same}")
    if not same:
        raise SystemExit("the dump is not the reference's program")

    period, n_scan, _ = PT._layer_plan(pcfg)
    k = max(1, pcfg.remat_every)
    n_scanned = (n_scan // k) * k * period
    print("layer kind  scanned  port gap  (x tol)   ref op-by-op gap  "
          "(x tol)")
    worst = 0.0
    for n in range(args.layers):
        kind, jbp = JT.get_block(jcfg, jp, n)
        _, tbp = PT.get_block(pcfg, tp, n)
        x_in, x_out = np.asarray(xs[n]), np.asarray(xs[n + 1])
        got = PT.block_seq(tbp, pcfg, kind, torch.from_numpy(x_in.copy()),
                           scanned=n < n_scanned)[0].numpy()
        with jax.disable_jit():
            eager = np.asarray(JT.block_seq(jbp, jcfg, kind,
                                            jnp.asarray(x_in))[0])
        worst = max(worst, ratio(got, x_out))
        print(f"{n:5d} {kind:5s} {str(n < n_scanned):8s} "
              f"{gap(got, x_out):9.3g} ({ratio(got, x_out):6.3f})   "
              f"{gap(eager, x_out):9.3g}        ({ratio(eager, x_out):6.3f})")
    port = PT.forward(pcfg, tp, {"tokens": torch.from_numpy(toks)})[0]
    with jax.disable_jit():
        eager = np.asarray(JT.forward(jcfg, jp,
                                      {"tokens": jnp.asarray(toks)})[0])
    print(f"worst single layer, port: {worst:.3f} x tol")
    print(f"end to end (logits): port {gap(port.numpy(), want):.3g} "
          f"({ratio(port.numpy(), want):.3f} x tol); reference op by op "
          f"{gap(eager, want):.3g} ({ratio(eager, want):.3f} x tol)")


if __name__ == "__main__":
    main()
