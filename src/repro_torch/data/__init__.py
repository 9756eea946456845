"""Deterministic, checkpointable synthetic data (counterpart of
``repro.data``)."""
from repro_torch.data.pipeline import ShardedPipeline
from repro_torch.data.synthetic import SyntheticTokens, make_token_pipeline

__all__ = ["ShardedPipeline", "SyntheticTokens", "make_token_pipeline"]
