"""Deterministic synthetic datasets (port of :mod:`repro.data.synthetic`;
numpy, copied verbatim against the port's own
:data:`repro_torch.models.cnn.PAPER_CNNS`, so every array equals the
reference's).

The container has no network access, so MNIST / ESC-10 / CIFAR-100 / VWW are
replaced by class-structured Gaussian-prototype generators with the same
input shapes and class counts.  ``separability`` controls the SNR, and
``environment`` applies a smooth domain shift (per-environment bias + gain).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..models.cnn import PAPER_CNNS


@dataclass(frozen=True)
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_classes(self) -> int:
        return int(self.y_train.max()) + 1


def _smooth_prototype(rng: np.random.Generator, shape) -> np.ndarray:
    """Low-frequency class prototype (so conv layers have structure to use)."""
    h, w, c = shape
    coarse = rng.normal(size=(max(2, h // 4), max(2, w // 4), c))
    out = np.kron(coarse, np.ones((4, 4, 1)))[:h, :w, :c]
    return out


def make_dataset(
    name: str,
    n_train: int = 512,
    n_test: int = 256,
    *,
    separability: float = 2.0,
    environment: int = 0,
    seed: int = 0,
) -> Dataset:
    cfg = PAPER_CNNS[name]
    rng = np.random.default_rng(seed)
    protos = np.stack(
        [_smooth_prototype(rng, cfg.input_shape) for _ in range(cfg.n_classes)]
    )

    def sample(n, split_seed):
        r = np.random.default_rng(split_seed)
        y = r.integers(0, cfg.n_classes, n)
        # per-sample amplitude + a cross-class confuser component: iid pixel
        # noise alone integrates away over ~1k pixels, which would make every
        # class trivially separable regardless of `separability`
        amp = r.uniform(0.6, 1.3, size=(n, 1, 1, 1))
        other = (y + 1 + r.integers(0, cfg.n_classes - 1, n)) % cfg.n_classes
        conf = r.uniform(0.0, 0.7, size=(n, 1, 1, 1))
        x = separability * (amp * protos[y] + conf * protos[other])
        x = x + r.normal(size=(n, *cfg.input_shape))
        if environment:
            er = np.random.default_rng(1000 + environment)
            # domain shift scales with the class-signal strength so a shift
            # meaningfully overlaps the class structure (paper Fig. 24:
            # lab -> hall -> office recordings lose ~8% accuracy)
            bias = er.normal(scale=0.5 * separability, size=cfg.input_shape)
            gain = 1.0 + er.normal(scale=0.2)
            x = gain * x + bias
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, seed * 7 + 1)
    x_te, y_te = sample(n_test, seed * 7 + 2)
    return Dataset(name, x_tr, y_tr, x_te, y_te)


def make_siamese_pairs(
    x: np.ndarray, y: np.ndarray, n_pairs: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """50% same-class / 50% different-class pairs (paper §4.2).

    Returns (x1, x2, different) where different=1 for cross-class pairs.
    """
    rng = np.random.default_rng(seed)
    by_class = {c: np.flatnonzero(y == c) for c in np.unique(y)}
    classes = sorted(by_class)
    i1 = np.empty(n_pairs, np.int64)
    i2 = np.empty(n_pairs, np.int64)
    diff = np.zeros(n_pairs, np.int32)
    for p in range(n_pairs):
        if p % 2 == 0:  # same class
            c = classes[rng.integers(len(classes))]
            a, b = rng.choice(by_class[c], 2, replace=True)
        else:
            c1, c2 = rng.choice(len(classes), 2, replace=False)
            a = rng.choice(by_class[classes[c1]])
            b = rng.choice(by_class[classes[c2]])
            diff[p] = 1
        i1[p], i2[p] = a, b
    return x[i1], x[i2], diff


def make_token_dataset(
    vocab: int,
    seq_len: int,
    n_classes: int,
    n_samples: int,
    *,
    separability: float = 1.5,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequence-classification tokens: each class has a biased unigram
    distribution over a class-specific vocabulary slice."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n_samples).astype(np.int32)
    logits = rng.normal(size=(n_classes, vocab))
    for c in range(n_classes):
        lo = (c * vocab) // n_classes
        hi = ((c + 1) * vocab) // n_classes
        logits[c, lo:hi] += separability
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    toks = np.stack(
        [rng.choice(vocab, seq_len, p=probs[c]) for c in y]
    ).astype(np.int32)
    return toks, y


def make_lm_tokens(
    vocab: int, seq_len: int, n_samples: int, seed: int = 0
) -> np.ndarray:
    """Markov-ish token streams for LM training demos."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, (n_samples, seq_len))
    # short-range structure: next token correlated with previous
    for t in range(1, seq_len):
        copy = rng.random(n_samples) < 0.3
        base[copy, t] = (base[copy, t - 1] + 1) % vocab
    return base.astype(np.int32)
