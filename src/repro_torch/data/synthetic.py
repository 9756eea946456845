"""Synthetic LM token stream (counterpart of
``repro.data.synthetic.SyntheticTokens`` and ``make_token_pipeline``).

A batch is a pure function of (seed, step): uniforms from
``fold_in(PRNGKey(seed), step)`` through ``prng.uniform`` (the reference's
``jax.random.uniform`` draws), mapped to a Zipf-like unigram by
``floor(vocab ** (1 - u) - 1)``.  The float32 power comes from PyTorch,
not XLA, so a rank can differ by one where the two round a value on
either side of an integer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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
