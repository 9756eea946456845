"""qwen3-moe-30b-a3b -- 128 experts top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H of 128 d_expert=768
vocab=151936; every layer MoE (no dense FFN layers)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    ffn_act="swiglu",
    pos="rope",
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, n_shared=0,
                  capacity_factor=1.25, first_dense=0),
)
