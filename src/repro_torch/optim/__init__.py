"""Low-precision optimizers with the paper's rounded update paths
(counterpart of ``repro.optim``: QSGD and QAdam)."""
from repro_torch.optim.adam import QAdam, QAdamState, qadam
from repro_torch.optim.sgd import QSGD, QSGDState, qsgd

__all__ = ["QAdam", "QAdamState", "QSGD", "QSGDState", "qadam", "qsgd"]
