"""Normalisation layers (counterparts of paddle_tpu/nn/norm.py: LayerNorm:13,
RMSNorm:36)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.nn_ops import layer_norm, rms_norm


class LayerNorm(nn.Module):
    """Weight at 1 and bias at 0; the reference's numerics (fp32 statistics,
    cast back to the input's dtype before the weight multiply), eps 1e-5."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
