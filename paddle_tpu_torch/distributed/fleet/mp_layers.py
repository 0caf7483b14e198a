"""Tensor-parallel (Megatron) layers (counterpart of paddle_tpu/distributed/
fleet/mp_layers.py:36-241; reference: Paddle's fleet/layers/mpu/
mp_layers.py and fleet/utils/sequence_parallel_utils.py).

The reference annotates whole-shaped weights over the mesh's mp axis and
lets GSPMD partition the products and insert the collectives (its
shard_map style issues them by hand, and shard_map's transpose sums a
replicated input's gradient). The port has neither: each mp rank holds
its block of every sharded weight (mesh.annotate_param cuts it) and
issues Megatron's collectives itself (distributed/collective.py's
regions):

  * ColumnParallelLinear: weight [in, out / n] and bias [out / n]; the
    input passes through `copy_to_model_parallel` (identity forward, the
    gradient all-reduced backward: every rank computes its part of the
    output from the same input, so the input's gradient is the sum of
    the parts'); `gather_output` all-gathers the output, whose backward
    keeps this rank's slice;
  * RowParallelLinear: weight [in / n, out]; with `input_is_parallel` the
    input is this rank's block of its last dimension, otherwise the layer
    takes that block (its backward all-gathers); the partial products
    are all-reduced (backward: identity), then the bias, whole, is added
    once;
  * VocabParallelEmbedding: rows [V / n, h]; an id outside this rank's
    rows looks up zeros, and the lookups are all-reduced;
  * ParallelCrossEntropy: over logits whose last dimension is this rank's
    block of the vocabulary: the max, the sum of exponentials and the
    picked logit reduced over the group, `ignore_index` labels giving 0;
    the backward is local (softmax minus the one-hot of this rank's
    block);
  * ColumnSequenceParallelLinear / RowSequenceParallelLinear: Megatron
    sequence parallelism, activations sharded over the sequence
    (dimension -2) between the pair: the column side all-gathers the
    sequence (backward: the sum-reduce-scatter), the row side
    reduce-scatters its partial products onto the sequence. The row
    side's bias, and the norms a caller puts around the pair, see only
    this rank's tokens: their gradients are partial
    (`mark_as_sequence_parallel_parameter`), and jit.TrainStep sums them
    over the group, as Megatron's hooks do.

A layer's group is the one its weight was cut over (at construction,
under `mp_group` or the current mesh's mp axis, or later by
sharding_utils.shard_model_parameters). With a group of one rank, or no
mesh, each layer is the one-device layer: the same parameter names,
[in, out] layout and state_dict keys. A layer whose weight is whole
while `mp_group`, or the current mesh's mp axis, has more than one rank
raises at its forward: it never runs the whole weight in place of its
block. Parameters are created uninitialised (the whole shape, then cut);
the model that owns them fills them with their block of the whole draw
from its generator (nn.layers.init_normal_).
"""
from __future__ import annotations

import torch
from torch import nn

from ...amp.state import cast_inputs
from ...ops import nn_ops
from ..collective import (ReduceOp, all_gather_autograd, all_reduce,
                          all_reduce_autograd, copy_to_model_parallel,
                          gather_replicated_autograd,
                          reduce_scatter_autograd, scatter_to_model_parallel)
from ..mesh import (PartitionSpec, annotate_param, get_mesh, mp_group_of,
                    shard_param)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "parallel_cross_entropy", "mark_as_sequence_parallel_parameter"]


def _mesh_group():
    """The current mesh's mp group when it has more than one rank."""
    mesh = get_mesh()
    if mesh is None or mesh.shape.get("mp", 1) == 1:
        return None
    g = mesh.group("mp")
    return g if g.rank >= 0 else None


def _annotate(layer, p, spec, name):
    """Record `p`'s spec, and cut it over the layer's `mp_group` when one
    was given, else over the current mesh's mp axis (annotate_param)."""
    label = f"{type(layer).__name__}.{name}"
    if layer.group is None:
        return annotate_param(p, spec, label)
    p._pspec = PartitionSpec(*spec)
    dim = next(i for i, a in enumerate(spec) if a == "mp")
    return shard_param(p, dim, layer.group, label)


def _group(layer):
    """The group `layer.weight` is cut over, or None when it is whole;
    raises when it is whole but should not be."""
    g = mp_group_of(layer.weight)
    if g is not None:
        return g
    want = layer.group if layer.group is not None else _mesh_group()
    if want is not None and want.nranks > 1 and want.rank >= 0:
        raise RuntimeError(
            f"{type(layer).__name__}: its weight {tuple(layer.weight.shape)}"
            f" is whole while the mp group has {want.nranks} ranks: build "
            "the layer under the mesh, or cut it with "
            "distributed.shard_model_parameters(model, mesh)")
    return None


def _param(*shape, device=None, dtype=None, zeros=False):
    make = torch.zeros if zeros else torch.empty
    return nn.Parameter(make(*shape, device=device, dtype=dtype))


def mark_as_sequence_parallel_parameter(p):
    """Mark `p` as one whose gradient each rank of the mp group holds only
    part of (a norm or bias applied to a sequence shard):
    jit.TrainStep sums its gradient over the group."""
    p.sequence_parallel = True
    return p


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.group = mp_group
        self.weight = _param(num_embeddings, embedding_dim, device=device,
                             dtype=dtype)
        _annotate(self, self.weight, ("mp", None), "weight")

    def forward(self, ids):
        g = _group(self)
        if g is None:
            return self.weight[ids]
        per = self.weight.shape[0]
        local = ids - g.rank * per
        inside = (local >= 0) & (local < per)
        emb = self.weight[torch.where(inside, local, torch.zeros_like(local))]
        emb = torch.where(inside[..., None], emb, torch.zeros_like(emb))
        return all_reduce_autograd(emb, g)


class ColumnParallelLinear(nn.Module):
    """Y = X W (+ b), W [in, out] cut on its output dim."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.group = mp_group
        self.weight = _param(in_features, out_features, device=device,
                             dtype=dtype)
        _annotate(self, self.weight, (None, "mp"), "weight")
        self.bias = None
        if has_bias:
            self.bias = _param(out_features, device=device, dtype=dtype,
                               zeros=True)
            _annotate(self, self.bias, ("mp",), "bias")

    def forward(self, x):
        g = _group(self)
        if g is None:
            return nn_ops.linear(x, self.weight, self.bias)
        out = nn_ops.linear(copy_to_model_parallel(x, g), self.weight,
                            self.bias)
        if self.gather_output:
            out = gather_replicated_autograd(out, -1, g)
        return out


class RowParallelLinear(nn.Module):
    """Y = X W (+ b), W [in, out] cut on its input dim; the partial
    products all-reduced, the bias added once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.group = mp_group
        self.weight = _param(in_features, out_features, device=device,
                             dtype=dtype)
        _annotate(self, self.weight, ("mp", None), "weight")
        self.bias = (_param(out_features, device=device, dtype=dtype,
                            zeros=True) if has_bias else None)

    def forward(self, x):
        g = _group(self)
        if g is None:
            return nn_ops.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = scatter_to_model_parallel(x, -1, g)
        out = all_reduce_autograd(nn_ops.linear(x, self.weight), g)
        return out if self.bias is None else out + self.bias.to(out.dtype)


class _ParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, g, ignore_index):
        per = logits.shape[-1]
        m = logits.max(dim=-1, keepdim=True).values
        if g is not None:
            all_reduce(m, ReduceOp.MAX, g)
        shifted = logits - m
        e = shifted.exp()
        s = e.sum(dim=-1, keepdim=True)
        label = label.long()
        local = label - (g.rank * per if g is not None else 0)
        inside = (local >= 0) & (local < per)
        safe = torch.where(inside, local, torch.zeros_like(local))
        picked = torch.where(inside, shifted.gather(
            -1, safe[..., None])[..., 0], torch.zeros_like(m[..., 0]))
        if g is not None:
            all_reduce(s, ReduceOp.SUM, g)
            all_reduce(picked, ReduceOp.SUM, g)
        valid = label != ignore_index
        loss = torch.where(valid, s[..., 0].log() - picked,
                           torch.zeros_like(picked))
        ctx.save_for_backward(e.div_(s), safe, inside & valid, valid)
        return loss

    @staticmethod
    def backward(ctx, grad):
        softmax, safe, hit, valid = ctx.saved_tensors
        gv = torch.where(valid, grad, torch.zeros_like(grad))
        d = softmax * gv[..., None]
        d.scatter_add_(-1, safe[..., None],
                       -torch.where(hit, gv, torch.zeros_like(gv))[..., None])
        return d, None, None, None


def parallel_cross_entropy(logits, label, group=None, ignore_index=-100):
    """The cross entropy of each row of `logits` (this rank's block of
    the vocabulary over `group`; the whole vocabulary with no group)
    against the global `label`, in fp32, 0 where the label is
    `ignore_index` (reduction none)."""
    (logits,) = cast_inputs("cross_entropy", logits)
    if group is not None and group.nranks <= 1:
        group = None
    return _ParallelCrossEntropy.apply(logits.float(), label, group,
                                       ignore_index)


class ParallelCrossEntropy(nn.Module):
    """Cross entropy over vocabulary-sharded logits (reference:
    mp_layers.py:524), reduction none."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        g = self.group if self.group is not None else _mesh_group()
        return parallel_cross_entropy(input, label, g, self.ignore_index)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Megatron sequence parallelism, input side (reference:
    sequence_parallel_utils.py:228): the input arrives as this rank's
    block of the sequence (dimension -2); it is all-gathered, then the
    column-parallel product."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         gather_output, mp_group=mp_group, device=device,
                         dtype=dtype)

    def forward(self, x):
        g = _group(self)
        if g is None:
            return nn_ops.linear(x, self.weight, self.bias)
        out = nn_ops.linear(all_gather_autograd(x, -2, g), self.weight,
                            self.bias)
        if self.gather_output:
            out = gather_replicated_autograd(out, -1, g)
        return out


class RowSequenceParallelLinear(RowParallelLinear):
    """Megatron sequence parallelism, output side (reference:
    sequence_parallel_utils.py:340): the row-parallel product whose
    partial sums are reduce-scattered onto the sequence (dimension -2),
    then the bias (marked sequence-parallel: each rank sees its tokens
    only)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         input_is_parallel, mp_group=mp_group,
                         device=device, dtype=dtype)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        g = _group(self)
        if g is None:
            return nn_ops.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            raise NotImplementedError(
                "RowSequenceParallelLinear under a bound mp axis requires "
                "input_is_parallel=True (split the input before the layer)")
        out = reduce_scatter_autograd(nn_ops.linear(x, self.weight), -2, g)
        return out if self.bias is None else out + self.bias.to(out.dtype)
