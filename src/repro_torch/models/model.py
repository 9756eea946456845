"""Model facade for the dense and MoE decoders: init, training loss and
cached decode (counterpart of ``repro.models.model``).

``decode_step`` keeps the reference's seed chain: with a GEMM policy and
a scalar position the step key is ``fold_in(PRNGKey(0), pos)``
(stochastic-rounding streams decorrelate across positions), each layer's
context comes from ``transformer.apply_blocks``, and the lm head runs
under ``ctx_for(cfg, rng)``.  Serving passes a (B,) position vector (every
slot at its own depth of a paged cache) and its own per-call ``rng``.
``prefill`` is the full-sequence forward that also emits the KV cache.
``loss_fn`` is the reference's chunked next-token cross-entropy: the lm
head runs over ``LOSS_CHUNK`` positions at a time under
``fold_ctx(ctx_for(cfg, rng), chunk)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.kernels import common
from repro_torch.models import attention, layers as L, transformer
from repro_torch.precision.policy import TAG_LOGITS, ctx_for, fold_ctx

LOSS_CHUNK = 1024


def store_params(tree):
    """The parameter tree as the port keeps it: the embedding and every
    GEMM weight rounded once to bf16 (their values as the GEMMs and the
    bf16 embedding lookup see them), norm scales float32 (see
    models/layers.py)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = store_params(v)
        elif k.startswith("norm") or k == "final_norm":
            out[k] = v.float()
        elif isinstance(v, list):            # per-layer expert stacks
            out[k] = [L.store_weight(t) for t in v]
        else:
            out[k] = L.store_weight(v)
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters from ``gen``, on ``gen.device``, as the port
        serves with them (``store_params``: GEMM weights and the
        embedding bf16, norm scales float32); the same tree and initial
        distributions as the reference's ``Model.init``.  Each leaf is
        drawn in float32 and rounded at once, so the peak is the stored
        tree plus one float32 leaf (30.5 B parameters fit one card)."""
        return self._draw(gen, L.COMPUTE_DTYPE)

    def init_master(self, gen: torch.Generator) -> Dict[str, Any]:
        """The float32 master parameters the trainer updates: the same
        draws as ``init``, unrounded."""
        return self._draw(gen, torch.float32)

    def _draw(self, gen: torch.Generator, dtype: torch.dtype
              ) -> Dict[str, Any]:
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  dtype=dtype),
            "blocks": transformer.init_blocks(gen, cfg, dtype=dtype),
            "final_norm": torch.zeros((cfg.d_model,), device=gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                             cfg.vocab_size, scale=0.02,
                                             dtype=dtype)
        return params

    def init_decode_cache(self, batch: int, max_len: int, device=None
                          ) -> Dict[str, attention.KVCache]:
        """The stacked KV cache in the policy's storage dtype (uint8 codes
        under an e4m3 ``kv_cache_fmt``, else bf16)."""
        return {"attn": attention.init_cache(self.cfg, batch, max_len,
                                             device=device)}

    def _logits(self, params, h, quant=None):
        if self.cfg.tie_embeddings:
            w = params["embed"].T.contiguous()
        else:
            w = params["lm_head"]
        return L.qdense(h, w, quant, TAG_LOGITS)

    def hidden_states(self, params, batch, rng: Optional[prng.Key] = None
                      ) -> torch.Tensor:
        """Full-sequence forward to the final hidden states (training)."""
        tokens = batch["tokens"]
        x = params["embed"][tokens].to(L.COMPUTE_DTYPE)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = transformer.apply_blocks(
            params["blocks"], x, positions, self.cfg,
            rng=rng if rng is not None else prng.PRNGKey(0))
        return L.rms_norm(x, params["final_norm"])

    def loss_fn(self, params, batch, rng: Optional[prng.Key] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Chunked next-token cross-entropy; returns (loss, metrics)."""
        h = self.hidden_states(params, batch, rng)
        labels = batch["labels"]
        B, S, _ = h.shape
        lq = ctx_for(self.cfg, rng if rng is not None else prng.PRNGKey(0))
        total, count = torch.zeros((), device=h.device), 0
        for i in range(max(1, -(-S // LOSS_CHUNK))):
            sl = slice(i * LOSS_CHUNK, min((i + 1) * LOSS_CHUNK, S))
            logits = self._logits(params, h[:, sl, :],
                                  quant=fold_ctx(lq, i)).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                labels[:, sl, None].long())[..., 0]
            total = total + torch.sum(logz - gold)
            count += logits.shape[0] * logits.shape[1]
        loss = total / count
        return loss, {"ce": loss, "moe_aux": torch.zeros((), device=h.device)}

    def prefill(self, params, batch, rng: Optional[prng.Key] = None,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, attention.KVCache]]:
        """Full-sequence forward that also emits the KV cache (each layer's
        k/v stored as decode would store them, in a cache of capacity
        ``max_len``, default the prompt length) and the next-token logits
        (B, 1, V)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        cap = S if max_len is None else int(max_len)
        if cap < S:
            raise ValueError(f"max_len={cap} is smaller than the prefill "
                             f"length {S}")
        rng = rng if rng is not None else prng.PRNGKey(0)
        caches = self.init_decode_cache(B, cap, device=tokens.device)
        x = params["embed"][tokens].to(L.COMPUTE_DTYPE)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = transformer.apply_blocks(params["blocks"], x, positions,
                                     self.cfg, rng=rng, emit=caches["attn"])
        caches["attn"].length = S
        x = L.rms_norm(x, params["final_norm"])
        return self._logits(params, x[:, -1:, :],
                            quant=ctx_for(self.cfg, rng)), caches

    @staticmethod
    def prime_cache_lengths(caches, length: int):
        """Mark ``length`` tokens as already present in the contiguous
        caches (decode-shape dry runs start from a full prefix)."""
        for c in caches.values():
            if isinstance(c, attention.KVCache):
                c.length = int(length)
        return caches

    def decode_step(self, params, caches, tokens: torch.Tensor, pos,
                    rng: Optional[prng.Key] = None,
                    compute_logits: bool = True
                    ) -> Tuple[Optional[torch.Tensor], Dict]:
        """Cached decode of ``tokens`` (B, S) (S > 1: a chunk of a prompt).
        ``pos``: the first new token's position, an int shared by the
        batch, or a (B,) host array of per-slot positions (a paged cache,
        every slot at its own depth).  ``rng``: the call's key (default
        ``PRNGKey(0)``, folded with a scalar ``pos`` under a GEMM policy).
        ``compute_logits=False`` skips the lm head (prompt absorption).
        The caches are updated in place and returned."""
        cfg = self.cfg
        scalar = np.ndim(pos) == 0
        if rng is None:
            rng = prng.PRNGKey(0)
            if cfg.gemm_policy is not None and scalar:
                rng = prng.fold_in(rng, int(pos))
        x = params["embed"][tokens].to(L.COMPUTE_DTYPE)
        B, S = tokens.shape
        if scalar:
            positions = (int(pos) + torch.arange(S, device=tokens.device)
                         )[None].expand(B, S)
        else:
            p = np.asarray(pos, dtype=np.int64).reshape(B)
            positions = common.host_to_device(
                p[:, None] + np.arange(S)[None], tokens.device)
        x = transformer.apply_blocks(params["blocks"], x, positions, cfg,
                                     caches=caches, rng=rng)
        if isinstance(caches["attn"], attention.KVCache):
            caches["attn"].length += S
        x = L.rms_norm(x, params["final_norm"])
        if not compute_logits:
            return None, caches
        return self._logits(params, x, quant=ctx_for(cfg, rng)), caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
