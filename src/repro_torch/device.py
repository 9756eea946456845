"""Device resolution for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
With no card and no explicit CPU request they raise: there is no silent
fallback, so a number taken on the CPU can never pass for a device number.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else the given device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' (CLI: "
                "--device cpu) to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA "
                           "device is available")
    return dev
