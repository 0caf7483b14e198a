"""Single-device counterparts of paddle_tpu/distributed/fleet/mp_layers.py
(VocabParallelEmbedding:36, ColumnParallelLinear:73, RowParallelLinear:91)
and of paddle_tpu/nn/layers.py (Embedding:34, Dropout:52).

Parameter names and shapes are the reference's, so a JAX state_dict maps
onto the port key by key: linear weights are stored [in, out] and applied as
x @ W. Parameters are trainable and created uninitialised on the given
device; the model that owns them fills them from its own torch.Generator.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import nn_ops


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return self.weight[ids]


class VocabParallelEmbedding(Embedding):
    """The reference's vocab-parallel embedding on one device (the whole
    vocabulary is local)."""


def module_generators(obj) -> list:
    """The torch.Generators held by `obj`'s modules (`obj` a Module or a
    bound method of one; otherwise none), deduplicated, in module order:
    the sources of the dropout masks that recomputation replays and a
    checkpoint carries."""
    owner = obj if isinstance(obj, nn.Module) \
        else getattr(obj, "__self__", None)
    if not isinstance(owner, nn.Module):
        return []
    seen, out = set(), []
    for m in owner.modules():
        for v in vars(m).values():
            if isinstance(v, torch.Generator) and id(v) not in seen:
                seen.add(id(v))
                out.append(v)
    return out


class Dropout(nn.Module):
    """Dropout whose keep mask comes from `generator` (a torch.Generator on
    the input's device; None draws from torch's default one)."""

    def __init__(self, p=0.5, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return nn_ops.dropout(x, self.p, self.training, self.generator)


class _Linear(nn.Module):
    """Y = X W (+ b), W [in, out]."""

    def __init__(self, in_features, out_features, has_bias=True, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        return nn_ops.linear(x, self.weight, self.bias)


class ColumnParallelLinear(_Linear):
    """The reference's column-parallel linear on one device (no output
    gather: the whole output dim is local)."""


class RowParallelLinear(_Linear):
    """The reference's row-parallel linear on one device (no all-reduce:
    the whole input dim is local)."""
