"""Precision policy: per-site GEMM rounding for the model stack."""
from repro_torch.precision.policy import (PRESETS, QuantCtx, QuantPolicy,
                                          get_policy, make_policy)

__all__ = ["PRESETS", "QuantCtx", "QuantPolicy", "get_policy",
           "make_policy"]
