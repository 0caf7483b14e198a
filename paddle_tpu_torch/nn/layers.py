"""Counterparts of paddle_tpu/nn/layers.py (Embedding:34, Dropout:52), and
the tensor-parallel layers the models build on, re-exported from
distributed/fleet/mp_layers.py (VocabParallelEmbedding,
ColumnParallelLinear, RowParallelLinear: one-device layers at mp 1).

Parameter names and shapes are the reference's, so a JAX state_dict maps
onto the port key by key: linear weights are stored [in, out] and applied as
x @ W. Parameters are trainable and created uninitialised on the given
device; the model that owns them fills them from its own torch.Generator
(`init_normal_` for a parameter that may be an mp block).
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


def init_normal_(p, std, generator):
    """Fill `p` in place from normal(0, std) drawn by `generator`: the
    whole parameter, or, for an mp block, its block of the whole draw (so
    the draws, and every later parameter's, are those of the model at mp
    1)."""
    from ..distributed.mesh import full_shape, shard_block

    shape = full_shape(p)
    if shape == tuple(p.shape):
        return p.normal_(0.0, std, generator=generator)
    whole = torch.empty(shape, dtype=p.dtype, device=p.device)
    return p.copy_(shard_block(whole.normal_(0.0, std, generator=generator),
                               p))


# the tensor-parallel layers (one definition; imported last: the
# distributed package imports this module's module_generators)
from ..distributed.fleet.mp_layers import (  # noqa: E402,F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
