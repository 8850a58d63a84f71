"""Minimal deterministic input pipeline: shuffled epoch batching (port of
:mod:`repro.data.pipeline`; numpy, copied verbatim, so every batch equals
the reference's)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def batches(
    x: np.ndarray, y: np.ndarray, batch_size: int, *, seed: int = 0,
    epochs: int = 1, drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    n = len(x)
    for e in range(epochs):
        rng = np.random.default_rng(seed + e)
        order = rng.permutation(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, stop, batch_size):
            idx = order[i : i + batch_size]
            yield x[idx], y[idx]


def siamese_batches(
    x1: np.ndarray, x2: np.ndarray, diff: np.ndarray, batch_size: int,
    *, seed: int = 0, epochs: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    n = len(x1)
    for e in range(epochs):
        rng = np.random.default_rng(seed + e)
        order = rng.permutation(n)
        stop = (n // batch_size) * batch_size
        for i in range(0, stop, batch_size):
            idx = order[i : i + batch_size]
            yield x1[idx], x2[idx], diff[idx]
