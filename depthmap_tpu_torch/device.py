"""The port's device rule: "cuda" (or a cuda:N) needs CUDA and raises
without it; nothing falls back to the CPU, which runs only when asked for."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"compute device {device!r} requested but CUDA "
                           "is not available")
    return dev
