"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card. Raises RuntimeError when CUDA is asked
    for (explicitly or by default) and there is none: the port never
    falls back to the CPU on its own. "cpu" passes through, and runs
    every kernel's plain PyTorch version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
