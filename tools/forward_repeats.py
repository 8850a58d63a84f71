"""Repeat ``chip_smoke.py``'s reduced qwen1.5-0.5b card-vs-CPU forward,
looking for a result that changes between runs.

    PYTHONPATH=src python tools/forward_repeats.py

1. The reduced ``forward`` of 2 x 128 tokens on the card against the CPU,
   eight times, each after the caching allocator's free memory is filled
   with one value (0, NaN, 1e30, -7, 3): an output that reads memory it
   never wrote would change with it.
2. Kernel G (f32 and bf16) at that forward's attention shape (2, 128, 4,
   64), causal, 5,000 launches each against the first launch's output.
3. The reduced ``forward`` on the card 300 times against its first run.

Prints the maximum error and the count of runs that differ for each.
Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def poison(dev, value: float) -> None:
    """Fill 2 GiB of the caching allocator's free blocks with ``value``."""
    blocks = [torch.full((1 << 26,), value, device=dev) for _ in range(8)]
    del blocks


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(1),
                           device=torch.device("cpu"))
    on_dev = convert.tree(params, dev)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 128)).astype(np.int32))
    ref = T.forward(cfg, params, {"tokens": toks})[0]
    for value in (0.0, float("nan"), 1e30, -7.0, float("nan"), 3.0, 0.0,
                  float("nan")):
        poison(dev, value)
        out = T.forward(cfg, on_dev, {"tokens": toks.to(dev)})[0].cpu()
        err = (out - ref).abs().nan_to_num(1e9)
        print(f"forward after poison {value}: max err vs CPU "
              f"{float(err.max()):.3g}, {int((err > 1e-4).sum())} logits "
              f"past 1e-4")
    g = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 128, 4, 64, device=dev,
                               generator=g).to(dtype) for _ in range(3))
        first = FA.flash_attention(q, k, v, causal=True).clone()
        bad = sum(not torch.equal(FA.flash_attention(q, k, v, causal=True),
                                  first) for _ in range(5000))
        print(f"kernel G {dtype} (2, 128, 4, 64) causal: {bad}/5000 "
              f"launches differ from the first")
    toks = toks.to(dev)
    first = T.forward(cfg, on_dev, {"tokens": toks})[0].clone()
    bad = sum(not torch.equal(T.forward(cfg, on_dev, {"tokens": toks})[0],
                              first) for _ in range(300))
    print(f"reduced forward on the card: {bad}/300 differ from the first")
    return 0


if __name__ == "__main__":
    sys.exit(main())
