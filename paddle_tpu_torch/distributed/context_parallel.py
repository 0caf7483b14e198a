"""Context (sequence) parallelism: ring attention and Ulysses attention
over a `sep` group (counterpart of paddle_tpu/distributed/
context_parallel.py).

The reference calls these functions on LOCAL shards inside a shard_map
over the "sep" mesh axis. Here each rank is a process (collective.py's
module note) and calls them on its own sequence shard, with a Group, or
the name of the current mesh's axis, in place of `axis_name`:

  * `ring_attention`: K/V chunks rotate around the ring by
    `collective_permute` (K and V in one message, no permute after the
    last step); each chunk's attention gives (o, lse) and the partial
    results merge by their logsumexp in fp32 (`_combine`). Under
    `causal`, a chunk from a later rank is skipped (no launch; o = 0 and
    lse = -1e30 enter the merge), the diagonal chunk is causal and the
    earlier ones are full. A chunk runs through the flash kernels
    (ops/gpu/flash_attention.py `flash_attention_with_lse`, whose lse
    is differentiable) where the reference's gate sends it to its Pallas
    kernel, else through the fp32 composition `_chunk_attention`.
  * `ulysses_attention`: one all-to-all of q, k and v together swaps
    the sharded dimension from sequence to heads, attention runs on the
    full sequence for h/n heads (flash where the reference's gate
    admits it), and one all-to-all swaps back. Heads must divide.

Both differentiate through the collectives' own backward (the inverse
permutation, the transposed all-to-all). Every rank must run the same
exchanges in its backward, also for a chunk it skipped: the last chunk
that arrived but was not used is tied to the output (`_tie`) with a zero
gradient, so its permute's backward runs on every rank.

`sequence_parallel_attention` is the reference's registered op
(ops.nn_ops re-exports it as the reference's `api` does): with no mesh,
or a `sep` axis of one rank, it is the dense composition on the arrays
given; otherwise q, k, v are this rank's shards. The sequence utilities
(`scatter_seq`, `all_gather_seq`, `reduce_scatter_seq`, `gather_seq`)
are the reference's, differentiable as JAX makes its collectives.
`gather_replicated` gathers an output that every rank then uses alike
(models/gpt.py without labels): its backward slices the cotangent,
where all_gather_seq's sums it.
`GradSum` sums a model's parameter gradients over the group from the
backward's post-accumulate hooks, so that after `loss.backward()` every
rank holds the gradients of the whole sequence (models/gpt.py arms it;
jit.TrainStep reduces over dp x sep itself and turns it off).

The host-staged gloo route of collective.py moves the exchanges'
bytes when two ranks share one card. Imports torch only.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..core.flags import get_flag
from ..ops.gpu import flash_attention as _flash
from .collective import (Group, all_gather_autograd, alltoall_single,
                         collective_permute, gather_replicated_autograd,
                         reduce_scatter_autograd)
from .grad_buckets import _group_of, default_bucket_bytes
from .mesh import get_mesh

__all__ = ["NEG_INF", "dense_causal_attention", "ring_attention",
           "ulysses_attention", "scatter_seq", "all_gather_seq",
           "reduce_scatter_seq", "gather_seq", "RingAttention",
           "sequence_parallel_attention", "gather_replicated", "GradSum",
           "attach_grad_sum",
           "grad_sum_disabled", "sep_group"]

NEG_INF = -1e30


def _chunk_attention(q, k, v, scale, extra_mask):
    """Dense attention on one KV chunk returning the per-row logsumexp.

    q: [b, sq, h, d]; k, v: [b, sk, h, d]; extra_mask: [sq, sk] additive
    fp32 (0 or NEG_INF) or None. Returns (o [b, sq, h, d] fp32, lse
    [b, h, sq] fp32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if extra_mask is not None:
        s = s + extra_mask[None, None, :, :]
    m = s.amax(dim=-1).clamp_min(NEG_INF)  # finite on a fully masked row
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)  # [b, h, sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    den = l.clamp_min(1e-30)
    lse = m + torch.log(den)
    return o / den.transpose(1, 2)[..., None], lse


def _combine(o, lse, o_i, lse_i):
    """Merge two normalized partial attentions by their logsumexps."""
    new_lse = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - new_lse).transpose(1, 2)[..., None]  # [b,sq,h,1]
    w_i = torch.exp(lse_i - new_lse).transpose(1, 2)[..., None]
    return o * w + o_i * w_i, new_lse


def _causal_mask(n, device):
    ids = torch.arange(n, device=device)
    return torch.where(ids[:, None] >= ids[None, :], 0.0,
                       NEG_INF).to(torch.float32)


def dense_causal_attention(q, k, v, causal=True, scale=None):
    """Plain dense attention on full [b, s, h, d] arrays: the one-rank
    path the sharded kernels reduce to."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    extra = _causal_mask(q.shape[1], q.device) if causal else None
    o, _ = _chunk_attention(q, k, v, scale, extra)
    return o.to(q.dtype)


def _flash_chunk_supported(sq, d):
    """The reference's gate for sending a ring chunk to flash: the flag,
    a local shard its ring blocks divide, d <= 256."""
    bq, bk = _flash.ring_block(sq)
    return bool(get_flag("use_flash_attention")) and sq % bq == 0 \
        and sq % bk == 0 and d <= _flash.MAX_HEAD_DIM


class _Tie(torch.autograd.Function):
    """`out` unchanged; the other inputs get zero gradients, so the
    backward reaches whatever produced them."""

    @staticmethod
    def forward(ctx, out, *others):
        ctx.others = [(t.shape, t.dtype, t.device) for t in others]
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(torch.zeros(s, dtype=dt, device=dev)
                               for s, dt, dev in ctx.others)


def _tie(out, *others):
    if not torch.is_grad_enabled() or \
            not any(t.requires_grad for t in others):
        return out
    return _Tie.apply(out, *others)


def _resolve(axis_name) -> Group:
    g = _group_of(axis_name)
    if g.rank < 0:
        raise ValueError(f"this rank is not in the group {g}")
    return g


def ring_attention(q, k, v, axis_name, causal=False, scale=None, rank=None):
    """Ring attention over the group of `axis_name` (a Group or a mesh
    axis). q, k, v: this rank's sequence shard [b, s_local, h, d]; the
    global sequence is the shards in group-rank order. Returns this
    rank's output shard, in q's dtype.

    The chunk arriving at step t came from group rank (rank - t) mod n: a
    later one is skipped under `causal`, the diagonal one (t = 0) gets the
    causal mask, earlier ones none."""
    group = _resolve(axis_name)
    n = group.nranks
    r = group.rank if rank is None else int(rank)
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _flash_chunk_supported(sq, d):
        def chunk(kc, vc, is_causal):
            o_i, lse_i = _flash.flash_attention_with_lse(q, kc, vc, scale,
                                                         is_causal)
            return o_i.float(), lse_i
    else:
        mask = _causal_mask(sq, q.device) if causal else None

        def chunk(kc, vc, is_causal):
            return _chunk_attention(q, kc, vc, scale,
                                    mask if is_causal else None)

    o = q.new_zeros((b, sq, h, d), dtype=torch.float32)
    lse = q.new_full((b, h, sq), NEG_INF, dtype=torch.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kc, vc = k, v
    used = True
    for step in range(n):
        src = (r - step) % n
        if causal and src > r:
            # a later rank's chunk: nothing to attend, nothing launched
            o_i = torch.zeros_like(o)
            lse_i = torch.full_like(lse, NEG_INF)
            used = False
        else:
            o_i, lse_i = chunk(kc, vc, causal and src == r)
            used = True
        o, lse = _combine(o, lse, o_i, lse_i)
        if step != n - 1:
            kc, vc = collective_permute((kc, vc), perm, group)
    if not used:
        o = _tie(o, kc, vc)
    return o.to(q.dtype)


def ulysses_attention(q, k, v, axis_name, causal=False, scale=None,
                      dense_fn=None):
    """Ulysses (all-to-all) sequence parallelism over the group of
    `axis_name`: q, k, v this rank's shards [b, s/n, h, d]; the heads
    must divide by the group's size. Attention runs on the full sequence
    for this rank's h/n heads, through `dense_fn(qf, kf, vf)` when
    given."""
    group = _resolve(axis_name)
    n = group.nranks
    b, sq, h, d = q.shape
    if h % n != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by axis size ({n})")
    # [3, b, s/n, h, d] -> [3, b, s, h/n, d]: q, k and v in one exchange
    qkv = alltoall_single(torch.stack((q, k, v)), group, split_axis=3,
                          concat_axis=2)
    qf, kf, vf = qkv.unbind(0)
    if dense_fn is not None:
        of = dense_fn(qf, kf, vf)
    else:
        of = _full_seq_attention(qf, kf, vf, causal=causal, scale=scale)
    return alltoall_single(of, group, split_axis=1, concat_axis=2)


def _full_seq_attention(qf, kf, vf, causal, scale):
    """Attention over the full sequence after the all-to-all: the flash
    kernels where the reference's gate admits the shapes (its dense
    fallback materialises an O(s^2) score matrix), else the dense
    composition."""
    if scale is None:
        scale = 1.0 / math.sqrt(qf.shape[-1])
    if get_flag("use_flash_attention") and _flash.supports(
            qf.shape, kf.shape, None, 0.0, causal):
        return _flash.flash_attention(qf, kf, vf, scale, causal)
    return dense_causal_attention(qf, kf, vf, causal=causal, scale=scale)


# ------------------------------------------------------------------ SP utils
# Reference: fleet/utils/sequence_parallel_utils.py (ScatterOp, GatherOp,
# AllGatherOp, ReduceScatterOp): Megatron sequence parallelism around TP
# blocks, as functions of this rank's shard.
def scatter_seq(x, axis_name):
    """This rank's 1/n slice of the sequence dim (dim 1, or dim 0 of a
    tensor of rank <= 2; ScatterOp)."""
    group = _resolve(axis_name)
    dim = 1 if x.dim() > 2 else 0
    chunk = x.shape[dim] // group.nranks
    return x.narrow(dim, group.rank * chunk, chunk)


def all_gather_seq(x, axis_name, seq_axis=1):
    """The sequence shards gathered to the full sequence (AllGatherOp);
    the backward is the sum-reduce-scatter of the gradient."""
    return all_gather_autograd(x, seq_axis, _resolve(axis_name))


def reduce_scatter_seq(x, axis_name, seq_axis=1):
    """The sum over the ranks, of which this rank keeps its sequence
    slice (ReduceScatterOp); the backward is the all-gather."""
    return reduce_scatter_autograd(x, seq_axis, _resolve(axis_name))


def gather_seq(x, axis_name, seq_axis=1):
    """Alias of all_gather_seq (the reference's GatherOp gathers to
    all)."""
    return all_gather_seq(x, axis_name, seq_axis)


def gather_replicated(x, axis_name, seq_axis=1):
    """The sequence shards gathered to the full sequence, for callers
    whose every rank then computes the same function of it (a
    sequence-parallel model's output): the cotangent is then the same on
    every rank, and the backward keeps this rank's slice of it. (The sum
    that all_gather_seq's backward takes would count it n times.)"""
    group = _resolve(axis_name)
    if group.nranks == 1:
        return x
    return gather_replicated_autograd(x, seq_axis, group)


class RingAttention:
    """Layer-style wrapper matching scaled_dot_product_attention's call on
    sequence-sharded inputs."""

    def __init__(self, axis_name="sep", causal=False):
        self.axis_name = axis_name
        self.causal = causal

    def __call__(self, q, k, v):
        return ring_attention(q, k, v, self.axis_name, causal=self.causal)


# ---------------------------------------------------------------- model hook
def sep_group(axis_name="sep"):
    """This rank's group along the current mesh's `axis_name`, or None
    when there is no mesh, no such axis or the axis is one rank (the
    dense path)."""
    mesh = get_mesh()
    if mesh is None or axis_name not in mesh.axis_names \
            or mesh.shape[axis_name] == 1:
        return None
    g = mesh.group(axis_name)
    return g if g.rank >= 0 else None


def sequence_parallel_attention(q, k, v, *, axis_name="sep", mode="ring",
                                causal=True):
    """Attention with the sequence sharded over `axis_name`: ring or
    Ulysses over this rank's shards [b, s/n, h, d], or, with no such
    axis of more than one rank, the dense composition on the arrays
    given (the reference's registered op)."""
    if mode not in ("ring", "ulysses"):
        raise ValueError(
            f"sequence_parallel mode must be 'ring' or 'ulysses', "
            f"got {mode!r}")
    group = sep_group(axis_name)
    if group is None:
        return dense_causal_attention(q, k, v, causal=causal)
    inner = ring_attention if mode == "ring" else ulysses_attention
    return inner(q, k, v, group, causal=causal)


_local = threading.local()


@contextlib.contextmanager
def grad_sum_disabled():
    """Models build no GradSum hooks inside the block (jit.TrainStep: it
    reduces the gradients over dp x sep itself)."""
    prev = getattr(_local, "off", False)
    _local.off = True
    try:
        yield
    finally:
        _local.off = prev


class GradSum:
    """Sum parameter gradients over a group from the backward's
    post-accumulate hooks, in buckets issued as they fill
    (overlap.BucketTrigger, one asynchronous all-reduce a bucket),
    drained at the end of that backward (an autograd engine callback), so
    `loss.backward()` returns with every rank holding the sum.
    `attach(out)` at a training forward: the backward that reaches `out`
    arms the hooks when it starts there, before any parameter's gradient
    is accumulated; a gradient already there is divided by the group's
    size first, so an accumulating backward adds the sum of the new
    gradients to it."""

    def __init__(self, params, group, bucket_bytes=None):
        from .overlap import BucketTrigger

        self.group = group
        self.trigger = BucketTrigger(
            params, group, bucket_bytes if bucket_bytes is not None
            else default_bucket_bytes(), "bucketed", divisor=1)
        self.armed = False

    def attach(self, out):
        """Hook the backward that will run through `out`."""
        out.register_hook(self._start)
        return out

    def _start(self, grad):
        if not self.armed:
            self.armed = True
            n = self.group.nranks
            for p in self.trigger.params:
                if p.grad is not None:
                    p.grad.div_(n)
            self.trigger.arm()
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        return grad

    def _finish(self) -> None:
        self.armed = False
        self.trigger.finish()


def attach_grad_sum(owner, group, out):
    """`out`, with the backward through it summing `owner`'s parameter
    gradients over `group` (owner's GradSum, made at its first use, alike
    on every rank); `out` untouched inside `grad_sum_disabled()` or
    without a graph."""
    if getattr(_local, "off", False) or not out.requires_grad:
        return out
    gs = owner.__dict__.get("_sp_grad_sum")
    if gs is None or gs.group is not group:
        gs = GradSum([p for p in owner.parameters() if p.requires_grad],
                     group)
        owner.__dict__["_sp_grad_sum"] = gs
    return gs.attach(out)
