"""The port's device rule: an entry point that takes a device runs on
CUDA unless asked for the CPU, and raises when it names CUDA and there
is none — nothing carries on on the CPU unasked."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a concrete `torch.device`; raises when it names CUDA
    and there is none (no entry point carries on on the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available; pass device='cpu' to run the "
                               "plain versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
