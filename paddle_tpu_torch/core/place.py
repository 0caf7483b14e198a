"""Device resolution (counterpart of paddle_tpu/core/place.py).

The port runs on the GPU. The CPU is used only when a caller asks for it by
name (the tests do, to hold the plain versions of the kernels against the
JAX reference); with no GPU and no such request, resolution raises instead of
carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device; a name or torch.device as given.
    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
