"""Checkpointing: parameter tree <-> ``.npz`` with path-flattened keys
(port of :mod:`repro.train.checkpoint`).

A key is the leaf's path, dict keys and sequence indices joined by ``/``
(``layers/stack/attn/wq``, ``convs/0/w``), as the reference writes it; a
bf16 leaf is written as f32 (npz has no bf16; the widening is exact).  A
transformer checkpoint written by the JAX package loads into the port and
one written by the port loads into the JAX package: both use the same
layouts.  The agile CNN's conv weights are OIHW in the port and HWIO in the
reference, so a CNN checkpoint round-trips within the port only
(:func:`repro_torch.convert.cnn_params_to_reference` carries port weights
across).
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict:
    flat = {}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return {prefix: t.numpy()}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def save_checkpoint(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors giving
    each leaf's shape, dtype and device); raises on a shape that
    differs."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def build(t, key):
        if isinstance(t, dict):
            return {k: build(v, f"{key}/{k}" if key else str(k))
                    for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v, f"{key}/{i}" if key else str(i))
                           for i, v in enumerate(t))
        arr = torch.from_numpy(np.array(data[key]))
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key}: shape "
                             f"{tuple(arr.shape)}, expected {tuple(t.shape)}")
        return arr.to(device=t.device, dtype=t.dtype)

    return build(like, "")
