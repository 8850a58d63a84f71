"""Why kernel G's scores must agree bit for bit with its plain version.

    PYTHONPATH=src python tools/flash_p_rounding_witness.py [--device cpu]

Kernel G rounds ``p = exp(s - m)`` to bf16 before the PV product, as the
reference does.  Two computations of the same f32 scores that differ only
in their summation order (the f32 einsum's, against the f32 rounding of
the exact dot product, which ``flash_attention_plain`` now forms) move some
``p`` across a bf16 rounding boundary.  This script takes bf16 inputs at
recurrentgemma-9b's geometry cut to 1,024 positions (16 heads on one kv
head, hd 256, causal, window 512; numpy seed 0), runs the plain version's
tile loop with both score computations, and prints the largest output gap
between the two and, for its row, every key whose rounded ``p`` differs:
both ``p`` before rounding, both after, and that key's share of the gap.
A kernel whose scores come from another summation order (the bf16 tensor
cores' own) shows gaps of this size against the plain version, far above
the 1e-5 it is held to.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.kernels import flash_attn as FA

B, S, H, KV, HD, WINDOW = 1, 1024, 16, 1, 256, 512


def _attend(q, k, v, exact: bool):
    """The plain version's tile loop, scores in f64 (``exact``) or f32;
    returns the output and, per tile, p before rounding and m."""
    G, scale = H // KV, HD ** -0.5
    dt = torch.float64 if exact else torch.float32
    qf = q.to(dt).reshape(B, S, KV, G, HD)
    qpos = torch.arange(S)
    m = torch.full((B, S, KV, G), FA.NEG)
    l = torch.zeros((B, S, KV, G))
    acc = torch.zeros((B, S, KV, G, HD))
    ps = []
    for j0 in range(0, S, FA.BLOCK_K):
        kpos = torch.arange(j0, j0 + FA.BLOCK_K)
        mask = FA._mask(qpos, kpos, S, True, WINDOW)
        s = torch.einsum("bqkgh,bckh->bqkgc", qf,
                         k[:, j0:j0 + FA.BLOCK_K].to(dt)).float() * scale
        s = torch.where(mask[None, :, None, None], s, FA.NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        ps.append(p)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p.to(v.dtype).float(),
            v[:, j0:j0 + FA.BLOCK_K].float())
        m = m_new
    return (acc / l[..., None]).reshape(B, S, H, HD), ps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(torch.bfloat16).to(args.device)
               for shape in ((B, S, H, HD), (B, S, KV, HD), (B, S, KV, HD)))
    exact, p_exact = _attend(q, k, v, True)
    f32, p_f32 = _attend(q, k, v, False)
    plain = FA.flash_attention_plain(q, k, v, window=WINDOW)
    assert torch.equal(plain, exact), "the plain version is the exact one"
    gap = (exact - f32).abs()
    bad = int((gap > 1e-5 + 1e-5 * exact.abs()).sum())
    b, pos, head, col = np.unravel_index(int(gap.argmax()), gap.shape)
    print(f"q/k/v bf16 (1, {S}, {H}/{KV}, hd {HD}), causal, window {WINDOW}: "
          f"{bad} of {gap.numel()} outputs differ by more than rtol = atol "
          f"= 1e-5 between f32-ordered and exactly rounded scores; largest "
          f"{float(gap.max()):.3g} at position {pos}, head {head}, column "
          f"{col}")
    g = head % (H // KV)
    for t, (pe, pf) in enumerate(zip(p_exact, p_f32)):
        pe, pf = pe[b, pos, 0, g], pf[b, pos, 0, g]
        flips = (pe.to(torch.bfloat16) != pf.to(torch.bfloat16)).nonzero()
        for (c,) in flips.tolist():
            key = t * FA.BLOCK_K + c
            print(f"  key {key}: p before rounding {float(pe[c]):.9g} "
                  f"(exact scores) vs {float(pf[c]):.9g} (f32 order); bf16 "
                  f"{float(pe[c].to(torch.bfloat16)):.9g} vs "
                  f"{float(pf[c].to(torch.bfloat16)):.9g}; v[{key}, {col}] = "
                  f"{float(v[b, key, 0, col]):.4g}")


if __name__ == "__main__":
    main()
