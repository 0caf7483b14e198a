"""Training step (counterpart of paddle_tpu/jit/trainer.py TrainStep).

The reference compiles forward, backward and the optimizer update into one
XLA program. PyTorch runs eagerly, so the port's step is the same sequence
as separate launches: `loss_fn(*batch)`, `backward()`, `optimizer.step()`
(gradient clip included) and `optimizer.clear_grad()`, with no host sync
inside; the caller decides when to read the loss. The reference's compiled
step updates through the plain `functional_update`, its eager AdamW through
the fused kernel; the port's step calls `optimizer.step()`, so it runs the
fused kernel (the two formulas are algebraically the same).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.place import resolve_device


class TrainStep:
    """Usage:
        step = TrainStep(model, loss_fn, optimizer)   # loss_fn(*batch)->loss
        loss = step(x, y)

    `device=None` is the current CUDA device (raising when there is none);
    the model's parameters must lie on the resolved device, and batch
    entries (tensors or numpy arrays) are moved there."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, device=None):
        self.device = resolve_device(device)
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"TrainStep on {self.device}: parameter "
                                 f"{name} is on {p.device}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def _place(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if torch.is_tensor(x):
            return x.to(self.device, non_blocking=True)
        return x

    def __call__(self, *batch):
        loss = self.loss_fn(*(self._place(x) for x in batch))
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()
