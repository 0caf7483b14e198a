"""Bucketed data-parallel gradient all-reduce (counterpart of
paddle_tpu/distributed/grad_buckets.py; reference: Paddle's DataParallel
fused all-reduce, build_groups and the coalesced gradient all-reduce).

Gradients are coalesced into fixed-byte buckets over the parameters in
reverse order (backward produces the last layers' gradients first, so
bucket 0 closes first) and each bucket is reduced by one all-reduce over
the data-parallel group. The reference emits each bucket as a `pmean`
inside its one compiled step; here a bucket is one torch.distributed
all-reduce (a sum, then a division for the mean), which TrainStep issues
asynchronously from the gradient hooks as soon as the bucket's last
member is ready (overlap.BucketTrigger).

A bucket's members are adjacent parameters of the list. `coalesce` lays
them out in ascending parameter order, the order of their memory in the
port's AdamW, which keeps every gradient as a view of one flat buffer per
parameter group (jit/trainer.py): when the members are adjacent in
memory, as they are when they all lie in one AdamW group, the coalesced
vector is a view of that buffer and the all-reduce runs in place, with no
copy. That holds for a model whose trainable parameters form one group
(GPT and Llama under AdamW without `apply_decay_param_fun`, the data-
parallel slice's case); a bucket that straddles two groups (decay on and
off alternate), or gradients of another optimizer, is concatenated into
a copy and scattered back. The reference concatenates in bucket order;
the reduction is elementwise, so the order changes no value.

Numerics: the all-reduce sums elementwise, so bucketing changes the
schedule and not the values of a two-rank sum; at larger worlds gloo's
ring may add a given element's contributions in another order for
another bucket size (tests/test_torch_grad_buckets.py).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core.flags import define_flag, get_flag
from ..observability.registry import counter as _obs_counter
from ..observability.registry import gauge as _obs_gauge
from ..observability.spans import span as _span

_FLUSHES = _obs_counter(
    "grad_bucket_flushes_total",
    "Gradient all-reduce buckets issued.")
_BUCKETS = _obs_gauge(
    "grad_bucket_count",
    "Bucket count of the most recent bucketed all-reduce.")

define_flag(
    "grad_bucket_mb", 4,
    "Coalesced gradient all-reduce bucket size (MB) for the data-parallel "
    "TrainStep path. 0 = one tensor per bucket; negative = single "
    "all-reduce over everything.",
)


def default_bucket_bytes() -> int:
    mb = int(get_flag("grad_bucket_mb"))
    if mb < 0:
        return 1 << 62  # everything in one bucket
    return mb << 20


def _dtype_key(dt):
    """(identity, itemsize) of a torch, numpy or named dtype."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch."), dt.itemsize
    d = np.dtype(dt)
    return d.name, d.itemsize


def partition_buckets(shapes: Sequence[tuple], dtypes: Sequence,
                      bucket_bytes: int) -> List[List[int]]:
    """Contiguous, dtype-uniform index buckets over REVERSED parameter
    order (the reference's lists exactly). A bucket never mixes dtypes and
    closes when adding the next tensor would pass `bucket_bytes`; a single
    oversized tensor still gets its own bucket."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i in reversed(range(len(shapes))):
        name, itemsize = _dtype_key(dtypes[i])
        nbytes = int(np.prod(shapes[i], dtype=np.int64) or 1) * itemsize
        if cur and (name != cur_dtype or cur_bytes + nbytes > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = name
    if cur:
        buckets.append(cur)
    return buckets


def _adjacent(g_vals, order) -> bool:
    """Do the tensors at `order` lie back to back, in that order, in one
    storage, each contiguous?"""
    first = g_vals[order[0]]
    base = first.untyped_storage().data_ptr()
    ptr = first.data_ptr()
    for i in order:
        g = g_vals[i]
        if g.dtype != first.dtype or not g.is_contiguous() or \
                g.untyped_storage().data_ptr() != base or g.data_ptr() != ptr:
            return False
        ptr += g.numel() * g.element_size()
    return True


def coalesce(g_vals, idxs: Sequence[int]) -> torch.Tensor:
    """The bucket members `idxs` of `g_vals` as one flat vector in
    ascending index order: a view of their memory when they lie back to
    back in it (a reduction then writes them in place), else a copy."""
    order = sorted(idxs)
    first = g_vals[order[0]]
    if len(order) == 1:
        return first.reshape(-1)
    if _adjacent(g_vals, order):
        n = sum(g_vals[i].numel() for i in order)
        return torch.as_strided(first, (n,), (1,), first.storage_offset())
    return torch.cat([g_vals[i].reshape(-1) for i in order])


def uncoalesce(red, idxs: Sequence[int], shapes, out: list) -> None:
    """Put the reduced vector's pieces back into `out` at the bucket's
    member positions (views of `red`, each in its member's shape)."""
    off = 0
    for i in sorted(idxs):
        n = int(np.prod(shapes[i], dtype=np.int64) or 1)
        out[i] = red[off:off + n].view(shapes[i])
        off += n


def _group_of(axis_name):
    """A Group, or the current mesh's group of this rank along the axis
    named."""
    from .collective import Group
    from .mesh import get_mesh

    if isinstance(axis_name, Group):
        return axis_name
    mesh = get_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis {axis_name!r} is not an axis of the current mesh "
            f"({None if mesh is None else mesh.shape}); build one with "
            "distributed.build_mesh and set_mesh, or pass a Group")
    return mesh.group(axis_name)


def bucket_reduce(g_vals, axis_name, bucket_bytes: int = None,
                  mean: bool = True):
    """Reduce gradients over the group of `axis_name` (a mesh axis or a
    Group) in coalesced buckets, one all-reduce each, waited for in turn.
    Returns the gradients in the original order, each summed (mean: and
    divided by the group's size) over the ranks. A bucket whose members
    lie back to back in memory is reduced in place (see the module
    note)."""
    from .collective import ReduceOp, all_reduce

    if bucket_bytes is None:
        bucket_bytes = default_bucket_bytes()
    group = _group_of(axis_name)
    shapes = [tuple(g.shape) for g in g_vals]
    out = [None] * len(g_vals)
    buckets = partition_buckets(shapes, [g.dtype for g in g_vals],
                                bucket_bytes)
    _BUCKETS.set(len(buckets))
    for idxs in buckets:
        with _span("dist.bucket_flush", cat="dist",
                   args={"tensors": len(idxs)}):
            _FLUSHES.inc()
            flat = all_reduce(coalesce(g_vals, idxs), ReduceOp.SUM, group)
            if mean and group.nranks > 1 and group.rank >= 0:
                flat.div_(group.nranks)
            uncoalesce(flat, idxs, shapes, out)
    return out
