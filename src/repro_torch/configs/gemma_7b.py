"""gemma-7b -- GeGLU, head_dim=256, MHA (kv=16), huge vocab.
[arXiv:2403.08295; hf]  28L d_model=3072 16H d_ff=24576 vocab=256000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    ffn_act="geglu",
    pos="rope",
    tie_embeddings=True,
)
