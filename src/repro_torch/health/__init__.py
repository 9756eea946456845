"""Fault tolerance (counterpart of ``repro.health``; only the fault
injector so far: the telemetry monitor and the watchdog are not ported
yet)."""
from repro_torch.health.inject import (FaultEvent, FaultInjector,
                                       corrupt_checkpoint, flip_bit,
                                       parse_fault_schedule)

__all__ = ["FaultEvent", "FaultInjector", "corrupt_checkpoint", "flip_bit",
           "parse_fault_schedule"]
