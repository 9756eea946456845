"""Training loop with fault tolerance (counterpart of ``repro.train``)."""
from repro_torch.train.loop import TrainLoop, TrainLoopConfig

__all__ = ["TrainLoop", "TrainLoopConfig"]
