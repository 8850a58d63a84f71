"""Diagonal linear recurrence of the RG-LRU (kernel I).

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py:rglru_scan``:
``a``, ``b`` ``(B, S, W)`` and ``h0`` ``(B, W)`` -> ``(h (B, S, W),
h_last (B, W))`` in f32 with ``h_t = a_t * h_{t-1} + b_t``.  The reference
kernel and its oracle (``kernels/ref.py:rglru_scan_ref``) both form ``a * h
+ b`` as one fused multiply-add on the CPU, so both versions here do too:
:func:`rglru_scan_plain` with :func:`repro_torch.core._fma.fma_f32`, the
CUDA kernel (``csrc/rglru_scan.cu``) with ``__fmaf_rn``.  They agree bit
for bit, and the plain version agrees bit for bit with the JAX kernel.
The reference pads the sequence with identity steps (``a = 1``, ``b =
0``); the kernel bounds-checks instead, which changes no bit.

The model's own path (:func:`repro_torch.models.rglru.rglru_seq`) launches
this kernel for a CUDA tensor; a CPU tensor there runs the port of the
reference's associative scan.
"""
from __future__ import annotations

import ctypes

import torch

from ..core._fma import fma_f32
from . import _build

#: launches of the CUDA kernel (the plain version never counts)
launches = 0


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor):
    """The plain PyTorch version: a loop over ``S`` with one rounding per
    step."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    h = h0.to(torch.float32)
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = fma_f32(a[:, t], h, b[:, t])
        out[:, t] = h
    return out, h


def _check(a, b, h0):
    if a.dim() != 3 or a.shape != b.shape or h0.shape != (a.shape[0],
                                                           a.shape[2]):
        raise ValueError(f"rglru_scan: a, b (B, S, W) and h0 (B, W); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if not (a.device == b.device == h0.device):
        raise ValueError("rglru_scan: inputs on different devices")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """``(h (B, S, W), h_last (B, W))`` f32.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (inputs cast to f32 and made
    contiguous)."""
    global launches
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    B, S, W = a.shape
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    h0 = h0.to(torch.float32).contiguous()
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h, h0.clone()
    if B > 65535:
        raise ValueError(f"rglru_scan: B={B} exceeds the kernel's grid")
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), B, S, W,
             h.data_ptr(), h_last.data_ptr(), _build.stream_handle(a.device))
    _build.check(err, "rglru_scan")
    launches += 1
    return h, h_last
