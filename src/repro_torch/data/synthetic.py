"""Synthetic data (counterpart of ``repro.data.synthetic``).

1. ``SyntheticTokens``, an LM token stream (and ``make_token_pipeline``).
2. ``synthetic_mnist`` / ``synthetic_binary_mnist``: the offline stand-in
   for MNIST of the paper's MLR and two-layer-NN experiments, plain numpy
   from a seed (no download), the reference's generator line for line, so
   both packages see the same arrays.

A token batch is a pure function of (seed, step): uniforms from
``fold_in(PRNGKey(seed), step)`` through ``prng.uniform`` (the reference's
``jax.random.uniform`` draws), mapped to a Zipf-like unigram by
``floor(vocab ** (1 - u) - 1)``.  The float32 power comes from PyTorch,
not XLA, so a rank can differ by one where the two round a value on
either side of an integer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """Deterministic synthetic LM token stream."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """Batch for an arbitrary step: int64 ``tokens`` and ``labels``,
        (global_batch, seq_len), on ``device``."""
        key = prng.fold_in(prng.PRNGKey(self.seed), step)
        u = prng.uniform(key, (self.global_batch, self.seq_len + 1),
                         minval=1e-6, maxval=1.0, device=device)
        ranks = torch.floor(float(self.vocab_size) ** (1.0 - u) - 1.0)
        toks = torch.clamp(ranks.to(torch.int64), 0, self.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_token_pipeline(vocab_size, seq_len, global_batch, seed=0):
    return SyntheticTokens(vocab_size=vocab_size, seq_len=seq_len,
                           global_batch=global_batch, seed=seed)


def synthetic_mnist(
    n_train: int = 6000,
    n_test: int = 1000,
    n_classes: int = 10,
    seed: int = 0,
    noise: float = 0.45,
    p_confusion: float = 0.05,
    contrast: float = 0.4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """MNIST-like 784-dim 10-class dataset. Returns (Xtr, ytr, Xte, yte).

    Each class has a distinct low-frequency template compressed toward
    mid-gray by ``contrast`` (so classification needs *fine* weights and
    keeps a long refinement tail — the regime where rounding precision
    matters, as on MNIST), plus a ``p_confusion`` fraction of samples
    rendered from a random other class's template (an irreducible error
    floor).  Calibrated so the fp32 MLR trajectory resembles the paper's
    (§5.2): smooth descent to ≈0.1 over ~150 full-batch epochs at t=0.5.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28] / 28.0

    def blob(freq):
        t = np.zeros((28, 28))
        for i in range(6):
            for j in range(6):
                t += freq[i, j] * np.sin(np.pi * (i + 1) * yy) \
                     * np.sin(np.pi * (j + 1) * xx)
        t = (t - t.min()) / (t.max() - t.min() + 1e-9)
        return t

    templates = np.stack(
        [0.5 + contrast * (blob(rng.normal(size=(6, 6))) - 0.5)
         for _ in range(n_classes)]).astype(np.float32)

    def make(n):
        y = rng.integers(0, n_classes, size=n)
        render = y.copy()
        conf = rng.random(n) < p_confusion
        render[conf] = rng.integers(0, n_classes, size=int(conf.sum()))
        x = templates[render] + noise * rng.normal(size=(n, 28, 28))
        x = np.clip(x, 0.0, 1.0).astype(np.float32)
        return x.reshape(n, 784), y.astype(np.int32)

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


def synthetic_binary_mnist(n_train: int = 4000, n_test: int = 800,
                           seed: int = 0, noise: float = 0.35):
    """Two-class (3-vs-8 stand-in) variant for the paper's §5.3 NN task."""
    xtr, ytr, xte, yte = synthetic_mnist(
        6 * n_train, 6 * n_test, n_classes=10, seed=seed, noise=noise)
    def filt(x, y, n):
        mask = (y == 3) | (y == 8)
        x, y = x[mask][:n], y[mask][:n]
        return x, (y == 8).astype(np.float32)
    xtr, ytr = filt(xtr, ytr, n_train)
    xte, yte = filt(xte, yte, n_test)
    return xtr, ytr, xte, yte
