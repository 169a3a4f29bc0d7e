"""Kernels written by hand for Hopper, each with its plain PyTorch
version and a launch counter (see build.py for how they are built)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class LaunchPlan:
    """One kernel launch as its wrapper hands it to the library: the
    device tensors the kernel reads, in the C call's order (`args`), the
    outputs and the scratch the wrapper allocates for it, the integer
    parameters of the call, and the dynamic shared memory one block
    takes. Each wrapper builds its launch from its plan, and the lint
    (gpu/lint.py) reads the same plan built on meta tensors, so what the
    lint prices is what the card runs. A plan copies and casts nothing:
    its wrapper refuses an input of the wrong dtype or layout."""

    args: dict[str, torch.Tensor]
    outputs: dict[str, torch.Tensor]
    params: dict[str, int]
    smem_bytes: int = 0
    scratch: torch.Tensor | None = None
