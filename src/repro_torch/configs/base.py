"""Model configuration (counterpart of ``repro.configs.base``).

The fields the dense decoder and MoE families need, named as in the
reference; the reference's MLA/SSM/RWKV/encoder/frontend/sliding-window
fields arrive with the families that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN width
    n_shared: int = 0          # always-on shared experts
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    first_dense: int = 0       # leading layers with a dense FFN instead


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    ffn_act: str = "swiglu"
    pos: str = "rope"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    # quantized-GEMM precision policy (paper eq. 8a): a preset name of
    # repro_torch.precision or a QuantPolicy; None keeps GEMMs unrounded
    gemm_policy: Optional[Any] = None
    # logical block sizes of the rounded flash-attention kernels: the av
    # site rounds once per kv block, so they are part of the numerics
    attn_q_block: int = 1024
    attn_kv_block: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def plan(self) -> Tuple[str, ...]:
        """The block sequence: "attn" (attention + FFN, the MoE FFN under
        ``moe``) and "attn_dense" (an MoE model's leading dense layers)."""
        if self.moe is not None:
            return ("attn_dense",) * self.moe.first_dense + \
                   ("attn",) * (self.n_layers - self.moe.first_dense)
        return ("attn",) * self.n_layers
