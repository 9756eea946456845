"""Low-precision optimizers with the paper's rounded update paths
(counterpart of ``repro.optim``; QSGD only so far)."""
from repro_torch.optim.sgd import QSGD, QSGDState, qsgd

__all__ = ["QSGD", "QSGDState", "qsgd"]
