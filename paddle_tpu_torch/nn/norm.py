"""RMSNorm layer (counterpart of paddle_tpu/nn/norm.py:36)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.nn_ops import rms_norm


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype),
                                   requires_grad=False)

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
