"""Architecture registry (counterpart of ``repro.configs``).

The dense decoders (SwiGLU and GeGLU) and the MoE family are ported;
``get_config`` raises for the reference's other architectures with "not
ported yet".
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.phi3_medium_14b import CONFIG as PHI3_MEDIUM_14B
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from repro_torch.configs.smollm_360m import CONFIG as SMOLLM_360M
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA_1_1B

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in [GEMMA_7B, PHI3_MEDIUM_14B, QWEN3_MOE_30B_A3B,
                        SMOLLM_360M, TINYLLAMA_1_1B]
}
NOT_PORTED = ("rwkv6-7b", "zamba2-1.2b", "deepseek-v2-236b", "qwen2-vl-7b",
              "seamless-m4t-medium")
ARCH_NAMES = sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; "
                                  f"ported: {ARCH_NAMES}")
    try:
        return REGISTRY[name]
    except KeyError as exc:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_NAMES}") \
            from exc


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (the reference's reduction,
    MoE included: 4 experts, top-2, d_expert 32)."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=4, top_k=2, d_expert=32,
                                  n_shared=min(moe.n_shared, 1),
                                  first_dense=min(moe.first_dense, 1))
    return dataclasses.replace(
        cfg,
        moe=moe,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
    )
