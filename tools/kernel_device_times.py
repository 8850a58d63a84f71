"""Device time per launch of kernels G and H, from the profiler.

    PYTHONPATH=src python tools/kernel_device_times.py

CUDA-event times of a wrapper call (``chip_smoke.py``) include the host
work between launches: at decode sizes the card waits on the wrapper.
This script runs ``flash_attention`` and ``decode_gqa`` at the shapes
``chip_smoke.py`` checks (bf16 G at its seven shapes, H at its six), 20
calls each under ``torch.profiler``, and prints per shape the device time
of every CUDA kernel the calls launched (per call), their sum, and the
host-clock time per call.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import decode_gqa as DG  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402

CALLS = 20


def profile(label: str, fn) -> None:
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / CALLS
    kernels = {}
    for e in p.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t and e.key and "Memcpy" not in e.key and "Memset" not in e.key \
                and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = t / CALLS / 1e3
    total = sum(kernels.values())
    parts = "; ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(
        kernels.items(), key=lambda kv: -kv[1]))
    print(f"{label}: device {total:.4f} ms per call, host clock "
          f"{1e3 * host:.4f} ms per call [{parts}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for B, S, Skv, H, KV, hd, causal, window, qo in \
            chip_smoke.FULL.flash_shapes:
        q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
        kw = dict(causal=causal, window=window, q_offset=qo)
        profile(f"G (B={B} S={S} Skv={Skv} H={H} KV={KV} hd={hd} window="
                f"{window} q_offset={qo}) bf16",
                lambda: FA.flash_attention(q, k, v, **kw))
    g = torch.Generator(device=dev).manual_seed(4)
    for shape in chip_smoke.FULL.decode_shapes:
        q, k, v, slot_pos, pos = chip_smoke._decode_inputs(shape, g, dev)
        B, H, KV, hd, C, dtype, round_p, window = shape
        kw = dict(window=window, round_p=round_p)
        profile(f"H (B={B} H={H} KV={KV} hd={hd} C={C} {dtype} round_p="
                f"{round_p}) splits={DG.split_plan(B, KV, C, 132)[0]}",
                lambda: DG.decode_gqa(q, k, v, slot_pos, pos, **kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
