"""Single-device counterparts of paddle_tpu/distributed/fleet/mp_layers.py
(VocabParallelEmbedding:36, ColumnParallelLinear:73, RowParallelLinear:91).

Parameter names and shapes are the reference's, so a JAX state_dict maps
onto the port key by key: linear weights are stored [in, out] and applied as
x @ W. Parameters are created uninitialised on the given device; the model
that owns them fills them from its own torch.Generator.
"""
from __future__ import annotations

import torch
from torch import nn


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype),
            requires_grad=False)

    def forward(self, ids):
        return self.weight[ids]


class _Linear(nn.Module):
    """Y = X W (+ b), W [in, out]."""

    def __init__(self, in_features, out_features, has_bias=True, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype),
                                  requires_grad=False)
                     if has_bias else None)

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class ColumnParallelLinear(_Linear):
    """The reference's column-parallel linear on one device (no output
    gather: the whole output dim is local)."""


class RowParallelLinear(_Linear):
    """The reference's row-parallel linear on one device (no all-reduce:
    the whole input dim is local)."""
