"""Collective communication (counterpart of paddle_tpu/distributed/
collective.py; reference: Paddle's ProcessGroup API and
python/paddle/distributed/communication/*).

Multi-controller: one process a rank. A `Group` holds a torch.distributed
process group over its ranks; the reference's Group holds a mesh axis
name, and its collectives are XLA ops inside a shard_map over that axis.
A group of one rank, or any group while no default process group is
initialised (world 1), makes every collective the identity, as the
reference's are outside a mesh. A rank outside the group does nothing.

Ranks are global ranks (`src`, `dst`, `peer`, a group's `ranks`); the
positions in `collective_permute`'s pairs are positions in the group, as
the reference's are positions along the axis.

Where the reference's single-controller program gives every rank a
result, a rooted collective here does what Paddle's does: `reduce` leaves
the result on `dst`, `gather` fills the list on `dst` only. `ReduceOp.AVG`
is a sum and a division where the backend has no average (gloo), and
`PROD` is the backend's product (the reference builds it from a sum of
logarithms). `sync_op=False` returns the work handle (`wait()`); an
average's division runs in it. A collective that the backend refuses on
the tensors' device raises: nothing is routed through a copy the code
does not state. Point-to-point ops on CUDA tensors under gloo raise here,
before gloo sees them: gloo's TCP pair writes from the device pointer,
fails (EFAULT) on its own thread and aborts the process (torch 2.11 on
an H100).

The one stated host route, `HOST_STAGED` ("host-staged gloo"): under
gloo, `collective_permute` and `alltoall_single` on CUDA tensors copy
them into pinned host buffers, run gloo on those CPU tensors and copy
the result back to the device. Gloo cannot send CUDA tensors and has no
all-to-all (torch 2.11 refuses it on CPU tensors too), so under gloo
`alltoall_single` is a send and a receive with every other rank. Context
parallelism (context_parallel.py)
exchanges K/V chunks and sequence shards through exactly these two
calls, with two ranks on one card where NCCL refuses to run. It moves
the bytes between ranks as gloo's own all-reduce of CUDA tensors does;
the computation stays on the card. Under NCCL the same calls stay on the
device (`transport()` names the route); every other caller keeps the
refusal. `transport_stats()` counts the two calls' bytes sent and host
seconds (from the call to the result on the device, the staging
included).

JAX differentiates ppermute, all_to_all, psum and all_gather itself;
here `collective_permute` and `alltoall_single` are differentiable
(their backward is the inverse permutation and the transposed
all-to-all), `all_reduce_autograd` is an all-reduce whose backward is
the identity (each rank's share of a loss summed over the group), and
`all_gather_autograd` / `reduce_scatter_autograd` are each other's
backward (the reference's tiled all_gather and psum_scatter).

Tensor parallelism's regions (Megatron's mappings; the reference's
shard_map transposes give them implicitly): `copy_to_model_parallel`
(identity, its backward the all-reduce of the gradient: a replicated
input of a column-parallel product), `all_reduce_autograd` (the
row-parallel product's partial sums), `gather_replicated_autograd`
(all-gather, its backward this rank's slice of a cotangent every rank
holds alike) and `scatter_to_model_parallel` (this rank's block, its
backward the all-gather). Their collectives are gloo's own on CUDA tensors
under gloo, which copies them through host memory itself
(`transport(..., op="all_reduce")` names that route, GLOO_STAGED); the
counters of `transport_stats()` take them too, by dtype. `split` builds
the reference's per-name tensor-parallel layer on first use.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

__all__ = [
    "ReduceOp", "Group", "get_group", "new_group", "all_reduce",
    "all_gather", "all_gather_concat", "reduce_scatter", "broadcast",
    "reduce", "all_to_all", "alltoall", "alltoall_single", "gather",
    "scatter", "collective_permute", "send", "recv", "isend", "irecv",
    "P2POp", "batch_isend_irecv", "barrier", "get_rank", "get_world_size",
    "axis_context", "all_reduce_autograd", "all_gather_autograd",
    "reduce_scatter_autograd", "transport", "transport_stats",
    "reset_transport_stats", "HOST_STAGED", "GLOO_STAGED",
    "reduce_scatter_flat", "all_gather_flat",
    "copy_to_model_parallel", "gather_replicated_autograd",
    "scatter_to_model_parallel", "split",
]

HOST_STAGED = "host-staged gloo"
# gloo's own collectives (all_reduce, all_gather, reduce_scatter) on CUDA
# tensors: gloo copies them through pinned host memory itself
GLOO_STAGED = "gloo-staged"
_HOST_ROUTED = ("collective_permute", "alltoall_single")


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _dist():
    import torch.distributed as dist

    return dist


def _active() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


class Group:
    """A communicator: global `ranks`, this process's position in them
    (`rank`, -1 outside), the mesh axis it stands for (`axis_name`) and
    the torch.distributed process group (`process_group`, None when the
    group is one rank or no default group exists)."""

    def __init__(self, rank, world_size, id=0, ranks=None,
                 axis_name: Optional[str] = None, process_group=None):
        self.rank = rank
        self.nranks = world_size
        self.id = id
        self.ranks = list(ranks) if ranks is not None \
            else list(range(world_size))
        self.axis_name = axis_name
        self.process_group = process_group

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, n={self.nranks}, "
                f"axis={self.axis_name}, ranks={self.ranks})")


_groups: Dict[int, Group] = {}
_next_group_id = [1]
_world_group: Optional[Group] = None


def _reset_groups() -> None:
    """Forget every group (the default process group was destroyed)."""
    global _world_group
    _groups.clear()
    _world_group = None


def _global_rank_world():
    if _active():
        dist = _dist()
        return dist.get_rank(), dist.get_world_size()
    from .env import get_rank as _gr
    from .env import get_world_size as _gw

    return _gr(), _gw()


def _get_world_group() -> Group:
    global _world_group
    if _world_group is None:
        rank, world = _global_rank_world()
        pg = _dist().group.WORLD if _active() and world > 1 else None
        _world_group = Group(rank, world, 0, list(range(world)),
                             process_group=pg)
    return _world_group


def get_group(gid=0) -> Group:
    if gid == 0:
        return _get_world_group()
    return _groups[gid]


def _make_group(ranks: Sequence[int], axis_name=None, backend=None,
                timeout=None) -> Group:
    """A Group over global `ranks`. Every rank of the world must call this
    in the same order (torch.distributed.new_group's rule), also for
    groups it is not in."""
    ranks = [int(r) for r in ranks]
    me, world = _global_rank_world()
    pg = None
    if _active() and len(ranks) > 1:
        dist = _dist()
        if ranks == list(range(world)) and backend is None:
            pg = dist.group.WORLD
        else:
            if timeout is None:
                from .env import pg_timeout

                timeout = pg_timeout()
            kw = {} if timeout is None else {"timeout": timeout}
            pg = dist.new_group(ranks, backend=backend, **kw)
    gid = _next_group_id[0]
    _next_group_id[0] += 1
    g = Group(ranks.index(me) if me in ranks else -1, len(ranks), gid,
              ranks, axis_name=axis_name, process_group=pg)
    _groups[gid] = g
    return g


def new_group(ranks=None, backend=None, timeout=None,
              axis_name=None) -> Group:
    """`ranks` (global), else the current mesh's group of this rank along
    `axis_name` (its process group is reused), else the whole world."""
    if ranks is None and axis_name is not None:
        from .mesh import get_mesh

        mesh = get_mesh()
        if mesh is not None and axis_name in mesh.axis_names:
            return mesh.group(axis_name)
    if ranks is None:
        ranks = range(_get_world_group().nranks)
    return _make_group(ranks, axis_name=axis_name, backend=backend,
                       timeout=timeout)


class axis_context:
    """The reference marks a shard_map trace that binds mesh axes, so its
    collectives resolve their axis. With a process a rank there is no
    trace to mark: a group carries its process group, and this is a
    no-op kept for the reference's callers."""

    def __init__(self, *axes):
        self.axes = [a for a in axes if a]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _resolve(group: Optional[Group]):
    """(group, process group) or (group, None) for the identity; a rank
    outside the group gets (None, None)."""
    g = group if group is not None else _get_world_group()
    if g.rank < 0:
        return None, None
    if g.nranks <= 1 or g.process_group is None or not _active():
        return g, None
    return g, g.process_group


class _Task:
    """A work handle whose `wait()` also runs what must follow the
    communication (an average's division)."""

    def __init__(self, work, after=None):
        self._work = work
        self._after = after

    def is_completed(self) -> bool:
        return self._work is None or self._work.is_completed()

    def wait(self, timeout=None):
        if self._work is not None:
            if timeout is None:
                self._work.wait()
            else:
                self._work.wait(timeout)
        if self._after is not None:
            self._after()
            self._after = None
        return True


def _done(value, sync_op):
    return value if sync_op else _Task(None)


def _torch_op(op):
    R = _dist().ReduceOp
    table = {ReduceOp.SUM: R.SUM, ReduceOp.MAX: R.MAX, ReduceOp.MIN: R.MIN,
             ReduceOp.PROD: R.PRODUCT}
    if op not in table:
        raise ValueError(f"unknown reduce op {op}")
    return table[op]


def _native_avg(pg) -> bool:
    return _dist().get_backend(pg) == "nccl"


def _reduce_call(fn, tensor, op, g, pg, sync_op, **kw):
    """Run `fn(tensor, op=..., group=pg, async_op=...)` with AVG as a sum
    and a division where the backend has no average."""
    div = op == ReduceOp.AVG and not _native_avg(pg)
    top = _dist().ReduceOp.AVG if op == ReduceOp.AVG and not div \
        else _torch_op(ReduceOp.SUM if div else op)
    work = fn(tensor, op=top, group=pg, async_op=not sync_op, **kw)
    after = (lambda: tensor.div_(g.nranks)) if div else None
    if sync_op:
        if after is not None:
            after()
        return tensor
    return _Task(work, after)


def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True):
    """In place; returns the tensor (the task with sync_op=False)."""
    g, pg = _resolve(group)
    if pg is None:
        return _done(tensor, sync_op)
    return _reduce_call(_dist().all_reduce, tensor, op, g, pg, sync_op)


def all_gather(tensor_list: Optional[list], tensor,
               group: Optional[Group] = None, sync_op=True, axis=0):
    """Appends every rank's tensor to `tensor_list` (returned); without a
    list, returns them stacked on a new leading dimension."""
    g, pg = _resolve(group)
    if pg is None:
        if tensor_list is not None:
            tensor_list.append(tensor)
            return tensor_list
        return tensor
    outs = [torch.empty_like(tensor) for _ in range(g.nranks)]
    _dist().all_gather(outs, tensor.contiguous(), group=pg)
    if tensor_list is not None:
        tensor_list.extend(outs)
        return tensor_list
    return torch.stack(outs)


def all_gather_concat(tensor, axis=0, group: Optional[Group] = None):
    """all_gather, then concatenation along `axis` (the reference's tiled
    all_gather)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return torch.cat(all_gather([], tensor, group), dim=axis)


def reduce_scatter(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op=True, axis=0):
    """The sum over ranks of `tensor`, of which this rank keeps the
    group-rank-th of `nranks` equal blocks along `axis` (returned; the
    reference's tiled psum_scatter)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    n = g.nranks
    if tensor.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(tensor.shape)}"
                         f" does not split into {n} ranks")
    parts = [c.contiguous() for c in torch.chunk(tensor, n, dim=axis)]
    out = torch.empty_like(parts[0])
    return _reduce_call(
        lambda t, **kw: _dist().reduce_scatter(t, parts, **kw), out, op, g,
        pg, sync_op)


def broadcast(tensor, src=0, group: Optional[Group] = None, sync_op=True):
    """In place, from global rank `src`."""
    g, pg = _resolve(group)
    if pg is None:
        return _done(tensor, sync_op)
    if src not in g.ranks:
        raise ValueError(f"rank {src} is not in group ranks {g.ranks}")
    work = _dist().broadcast(tensor, src, group=pg, async_op=not sync_op)
    return tensor if sync_op else _Task(work)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group: Optional[Group] = None,
           sync_op=True):
    """In place; the result is defined on global rank `dst` only."""
    g, pg = _resolve(group)
    if pg is None:
        return _done(tensor, sync_op)
    if dst not in g.ranks:
        raise ValueError(f"rank {dst} is not in group ranks {g.ranks}")
    return _reduce_call(_dist().reduce, tensor, op, g, pg, sync_op, dst=dst)


def all_to_all(out_tensor_list, in_tensor_list,
               group: Optional[Group] = None, sync_op=True):
    """Rank j receives this rank's `in_tensor_list[j]`; the received
    tensors are appended to `out_tensor_list` (returned) in rank order."""
    g, pg = _resolve(group)
    if pg is None:
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    ins = [t.contiguous() for t in in_tensor_list]
    outs = [torch.empty_like(t) for t in ins]
    _dist().all_to_all(outs, ins, group=pg)
    out_tensor_list.extend(outs)
    return out_tensor_list


alltoall = all_to_all  # the reference exposes both spellings


def alltoall_single(tensor, group: Optional[Group] = None, split_axis=0,
                    concat_axis=0):
    """One tensor's all-to-all (the reference's tiled lax.all_to_all):
    `tensor` splits into `nranks` blocks along `split_axis`, block j goes
    to rank j, and the blocks received are concatenated along
    `concat_axis` in rank order. Differentiable: the backward is the
    all-to-all with the two axes swapped. CUDA tensors under gloo take
    the host route (see the module note)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    if tensor.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(tensor, g, split_axis, concat_axis)
    return _alltoall_raw(tensor, g, pg, split_axis, concat_axis)


def _alltoall_raw(tensor, g, pg, split_axis, concat_axis):
    if tensor.shape[split_axis] % g.nranks:
        raise ValueError(f"alltoall_single: dim {split_axis} of "
                         f"{tuple(tensor.shape)} does not split into "
                         f"{g.nranks} ranks")
    t0 = time.perf_counter()
    chunks = torch.chunk(tensor, g.nranks, dim=split_axis)
    me = g.rank
    if _dist().get_backend(pg) == "gloo":
        # gloo has no all-to-all (torch 2.11 refuses it on any tensor): a
        # send and a receive with every other rank; on the host route only
        # the blocks that travel are staged
        staged = _staged(tensor, pg)
        peers = [j for j in range(g.nranks) if j != me]
        sends = _to_host([chunks[j] for j in peers]) if staged else \
            [chunks[j].contiguous() for j in peers]
        recvs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=staged)
                 for t in sends]
        ops: List[P2POp] = []
        for j, snd, rcv in zip(peers, sends, recvs):
            ops += [P2POp(isend, snd, g.ranks[j], g),
                    P2POp(irecv, rcv, g.ranks[j], g)]
        for work in _p2p_works(ops):
            work.wait()
        outs = list(chunks)
        for j, rcv in zip(peers, recvs):
            # the host allocator keeps a pinned buffer until its copy ran
            outs[j] = rcv.to(tensor.device, non_blocking=True) if staged \
                else rcv
        nbytes = sum(t.numel() * t.element_size() for t in sends)
    else:
        ins = [c.contiguous() for c in chunks]
        outs = [torch.empty_like(c) for c in ins]
        _dist().all_to_all(outs, ins, group=pg)
        nbytes = sum(t.numel() * t.element_size()
                     for j, t in enumerate(ins) if j != me)
    out = torch.cat(outs, dim=concat_axis)
    _note("alltoall_single", nbytes, t0)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, g, split_axis, concat_axis):
        ctx.g, ctx.axes = g, (split_axis, concat_axis)
        return _alltoall_raw(tensor, g, g.process_group, split_axis,
                             concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return (_alltoall_raw(grad.contiguous(), ctx.g,
                              ctx.g.process_group, concat_axis, split_axis),
                None, None, None)


def gather(tensor, gather_list: Optional[list] = None, dst=0,
           group: Optional[Group] = None, sync_op=True):
    """Global rank `dst` appends every rank's tensor to `gather_list`
    (returned); the other ranks' lists are left as they were."""
    g, pg = _resolve(group)
    out = gather_list if gather_list is not None else []
    if pg is None:
        out.append(tensor)
        return out
    if dst not in g.ranks:
        raise ValueError(f"rank {dst} is not in group ranks {g.ranks}")
    me = _global_rank_world()[0]
    bufs = [torch.empty_like(tensor) for _ in range(g.nranks)] \
        if me == dst else None
    _dist().gather(tensor.contiguous(), bufs, dst=dst, group=pg)
    if bufs is not None:
        out.extend(bufs)
    return out


def scatter(tensor, tensor_list=None, src=0, group: Optional[Group] = None,
            sync_op=True):
    """In place: this rank receives global rank `src`'s
    `tensor_list[group rank]` (only `src`'s list is read)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    if src not in g.ranks:
        raise ValueError(f"rank {src} is not in group ranks {g.ranks}")
    me = _global_rank_world()[0]
    parts = [t.contiguous() for t in tensor_list] if me == src else None
    _dist().scatter(tensor, parts, src=src, group=pg)
    return tensor


def barrier(group: Optional[Group] = None):
    g, pg = _resolve(group)
    if pg is not None:
        _dist().barrier(group=pg)


def get_rank(group=None) -> int:
    """This process's global rank (the reference ignores `group` too; a
    Group's own position is `group.rank`)."""
    return _global_rank_world()[0]


def get_world_size(group=None) -> int:
    return _global_rank_world()[1]


# -- point to point ------------------------------------------------------------
#
# Real sends and receives between processes. The reference pairs a send
# and a recv of its one program into a collective-permute edge; here each
# rank calls the half it plays.

def _check_p2p(tensor, pg) -> None:
    """Refuse a CUDA tensor's send or receive under gloo (see the module
    note): the alternative is an abort on gloo's I/O thread."""
    if tensor.is_cuda and _dist().get_backend(pg) == "gloo":
        raise RuntimeError(
            "gloo cannot send or receive CUDA tensors (its TCP pair writes "
            "from the device pointer and aborts the process); use the nccl "
            "backend, or move the tensors to the CPU")


def send(tensor, dst=0, group=None, sync_op=True):
    g, pg = _resolve(group)
    if pg is None:
        return _done(tensor, sync_op)
    _check_p2p(tensor, pg)
    if sync_op:
        _dist().send(tensor.contiguous(), dst, group=pg)
        return tensor
    return _Task(_dist().isend(tensor.contiguous(), dst, group=pg))


def recv(tensor, src=0, group=None, sync_op=True):
    """In place, from global rank `src`."""
    g, pg = _resolve(group)
    if pg is None:
        return _done(tensor, sync_op)
    _check_p2p(tensor, pg)
    if sync_op:
        _dist().recv(tensor, src, group=pg)
        return tensor
    return _Task(_dist().irecv(tensor, src, group=pg))


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One half of a point-to-point exchange (reference:
    distributed.P2POp): `op` is send/isend or recv/irecv, `peer` a global
    rank."""

    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def _p2p_works(p2p_op_list):
    """Start every op of the list in one batch; their work handles."""
    dist = _dist()
    ops = []
    for op in p2p_op_list:
        _, pg = _resolve(op.group)
        _check_p2p(op.tensor, pg)
        fn = dist.isend if op.op in (send, isend) else dist.irecv
        ops.append(dist.P2POp(fn, op.tensor, op.peer, group=pg))
    return dist.batch_isend_irecv(ops)


def batch_isend_irecv(p2p_op_list):
    """Run the sends and receives of the list as one batch and wait for
    them; returns the receive tensors, filled in place (as the reference
    does). Outside a group, each receive takes the value of the send at
    its position among the sends."""
    sends = [op for op in p2p_op_list if op.op in (send, isend)]
    recvs = [op for op in p2p_op_list if op.op in (recv, irecv)]
    if not p2p_op_list:
        return []
    if _resolve(p2p_op_list[0].group)[1] is None:
        if len(sends) != len(recvs):
            raise ValueError(
                f"batch_isend_irecv outside a group needs matched send/recv "
                f"pairs, got {len(sends)} sends / {len(recvs)} recvs")
        for s_op, r_op in zip(sends, recvs):
            r_op.tensor.copy_(s_op.tensor)
        return [r.tensor for r in recvs]
    for work in _p2p_works(p2p_op_list):
        work.wait()
    return [r.tensor for r in recvs]


def collective_permute(tensor, perm: Sequence[tuple],
                       group: Optional[Group] = None):
    """The reference's ppermute: `perm` holds (source, destination)
    positions in the group; returns what this rank receives, zeros when
    no pair ends here. `tensor` may be a tuple or list of tensors of one
    dtype (the reference permutes a pytree), sent as one message each
    way; a tuple comes back. Differentiable: the backward permutes the
    gradients by the inverse pairs. CUDA tensors under gloo take the host
    route (see the module note)."""
    many = isinstance(tensor, (tuple, list))
    tensors = tuple(tensor) if many else (tensor,)
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    perm = [(int(s), int(d)) for s, d in perm]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        outs = _Permute.apply(g, perm, *tensors)
    else:
        outs = _permute_raw(tensors, perm, g, pg)
    return tuple(outs) if many else outs[0]


def _permute_raw(tensors, perm, g, pg):
    """The exchange of `collective_permute`: every tensor flattened into
    one buffer, one send and one receive a pair."""
    t0 = time.perf_counter()
    dtype = tensors[0].dtype
    if any(t.dtype != dtype for t in tensors):
        raise TypeError("collective_permute: tensors of one dtype only")
    flat = torch.cat([t.reshape(-1) for t in tensors]) \
        if len(tensors) > 1 else tensors[0].reshape(-1)
    staged = _staged(flat, pg)
    send = _to_host([flat])[0] if staged else flat.contiguous()
    recv = torch.zeros(send.shape, dtype=send.dtype, pin_memory=staged)
    me = g.rank
    ops: List[P2POp] = []
    for s, d in perm:
        if s == me:
            ops.append(P2POp(isend, send, g.ranks[d], g))
        if d == me:
            ops.append(P2POp(irecv, recv, g.ranks[s], g))
    if ops:
        for work in _p2p_works(ops):
            work.wait()
    if staged:      # the host allocator keeps `recv` until the copy ran
        recv = recv.to(flat.device, non_blocking=True)
    _note("collective_permute", send.numel() * send.element_size()
          * sum(s == me for s, _ in perm), t0)
    outs, off = [], 0
    for t in tensors:
        outs.append(recv[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return outs


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, perm, *tensors):
        ctx.g, ctx.perm = g, perm
        return tuple(_permute_raw(tensors, perm, g, g.process_group))

    @staticmethod
    def backward(ctx, *grads):
        inverse = [(d, s) for s, d in ctx.perm]
        back = _permute_raw(tuple(gr.contiguous() for gr in grads), inverse,
                            ctx.g, ctx.g.process_group)
        return (None, None) + tuple(back)


# -- the host route and the exchange's counters ----------------------------

_TRANSPORT: Dict[str, Dict[str, float]] = {}


def _staged(tensor, pg) -> bool:
    """Does this exchange take the host route (CUDA tensors under
    gloo)?"""
    return tensor.is_cuda and _dist().get_backend(pg) == "gloo"


def transport(tensor, group: Optional[Group] = None,
              op: str = "collective_permute") -> str:
    """The route collective `op` takes for `tensor` over `group`: "local"
    (no process group: the identity); for `collective_permute` and
    `alltoall_single`, HOST_STAGED or "device"; for gloo's own collectives
    (`all_reduce`, `all_gather`, `reduce_scatter`), GLOO_STAGED (CUDA
    tensors under gloo) or "device"."""
    _, pg = _resolve(group)
    if pg is None:
        return "local"
    if not _staged(tensor, pg):
        return "device"
    return HOST_STAGED if op in _HOST_ROUTED else GLOO_STAGED


def _to_host(tensors):
    """Pinned host copies of CUDA tensors, complete before it returns
    (gloo reads them from its own threads)."""
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return hosts


def _note(name, nbytes, t0, dtype=None) -> None:
    ent = _TRANSPORT.setdefault(name, {"calls": 0, "bytes": 0,
                                       "seconds": 0.0})
    ent["calls"] += 1
    ent["bytes"] += int(nbytes)
    ent["seconds"] += time.perf_counter() - t0
    if dtype is not None:
        by = ent.setdefault("dtypes", {})
        key = str(dtype).removeprefix("torch.")
        by[key] = by.get(key, 0) + 1


def transport_stats() -> Dict[str, Dict[str, float]]:
    """{call: {calls, bytes, seconds}} since the last reset: the bytes
    this rank sent for collective_permute and alltoall_single; the bytes
    of this rank's tensor for the tensor-parallel regions' collectives
    ("all_reduce", "all_reduce_grad": a copy region's backward,
    "all_gather", "reduce_scatter"); the whole flat buffer's bytes for
    ZeRO's "reduce_scatter_flat" and "all_gather_flat" (the buffer
    reduced, the buffer gathered into). All but the first two also count
    their calls by dtype ("dtypes"). Seconds are the host's, from the
    call to the result."""
    return {k: {f: dict(v) if isinstance(v, dict) else v
                for f, v in ent.items()} for k, ent in _TRANSPORT.items()}


def reset_transport_stats() -> None:
    _TRANSPORT.clear()


# -- flat buffers (ZeRO, distributed/sharding.py) ---------------------------

def reduce_scatter_flat(out, flat, group: Optional[Group] = None):
    """The sum over the group's ranks of the 1-D buffer `flat`, cut into
    `nranks` equal chunks, of which this rank's chunk lands in `out`
    (returned). Under gloo a CUDA buffer takes gloo's own staging through
    host memory (`transport(..., op="reduce_scatter")`). Counted under
    "reduce_scatter_flat" by dtype."""
    g, pg = _resolve(group)
    if g is None:
        return out
    if flat.dim() != 1 or flat.numel() != g.nranks * out.numel():
        raise ValueError(f"reduce_scatter_flat: {tuple(flat.shape)} is not "
                         f"{g.nranks} chunks of {tuple(out.shape)}")
    if pg is None:
        return out.copy_(flat)
    t0 = time.perf_counter()
    _dist().reduce_scatter(out, list(flat.chunk(g.nranks)), group=pg)
    _note("reduce_scatter_flat", flat.numel() * flat.element_size(), t0,
          flat.dtype)
    return out


def all_gather_flat(out, chunk, group: Optional[Group] = None):
    """Every rank's 1-D `chunk` into the 1-D `out` (`nranks` chunks in
    group order; returned). `chunk` may be `out`'s own chunk: the gather
    is then in place. Counted under "all_gather_flat" by dtype."""
    g, pg = _resolve(group)
    if g is None:
        return out
    if out.dim() != 1 or out.numel() != g.nranks * chunk.numel():
        raise ValueError(f"all_gather_flat: {tuple(out.shape)} is not "
                         f"{g.nranks} chunks of {tuple(chunk.shape)}")
    if pg is None:
        if out.data_ptr() != chunk.data_ptr():
            out.copy_(chunk)
        return out
    t0 = time.perf_counter()
    _dist().all_gather(list(out.chunk(g.nranks)), chunk, group=pg)
    _note("all_gather_flat", out.numel() * out.element_size(), t0,
          out.dtype)
    return out


# -- differentiable reductions ---------------------------------------------

def _sum_noted(tensor, g, name):
    """all_reduce (SUM, in place) over `g`, counted under `name`."""
    t0 = time.perf_counter()
    all_reduce(tensor, ReduceOp.SUM, g)
    _note(name, tensor.numel() * tensor.element_size(), t0, tensor.dtype)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, g):
        return _sum_noted(tensor.detach().clone(), g, "all_reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, g):
        ctx.g = g
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return _sum_noted(grad.contiguous().clone(), ctx.g,
                          "all_reduce_grad"), None


def copy_to_model_parallel(tensor, group: Optional[Group] = None):
    """The identity whose backward all-reduces the gradient over the
    group: a replicated input of a computation that each rank does a part
    of (a column-parallel product) gets the sum of the parts' gradients,
    the same on every rank. No group (None) is the identity: a whole
    layer's."""
    if group is None:
        return tensor
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _CopyToModelParallel.apply(tensor, g)


def all_reduce_autograd(tensor, group: Optional[Group] = None):
    """The sum over the group, out of place, with the identity as its
    backward: each rank's share of a sum that every rank then holds (a
    loss summed over the ranks) gets the sum's gradient."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _AllReduceSum.apply(tensor, g)


def _gather_noted(tensor, axis, g):
    t0 = time.perf_counter()
    out = all_gather_concat(tensor.contiguous(), axis, g)
    _note("all_gather", tensor.numel() * tensor.element_size(), t0,
          tensor.dtype)
    return out


def _scatter_noted(tensor, axis, g):
    t0 = time.perf_counter()
    out = reduce_scatter(tensor.contiguous(), ReduceOp.SUM, g, axis=axis)
    _note("reduce_scatter", tensor.numel() * tensor.element_size(), t0,
          tensor.dtype)
    return out


def _block(tensor, axis, g):
    """This rank's contiguous block of `nranks` along `axis`."""
    n = tensor.shape[axis]
    if n % g.nranks:
        raise ValueError(f"dim {axis} of {tuple(tensor.shape)} does not "
                         f"split into {g.nranks} ranks")
    m = n // g.nranks
    return tensor.narrow(axis, g.rank * m, m).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, g, axis):
        ctx.g, ctx.axis = g, axis
        return _gather_noted(tensor, axis, g)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_noted(grad, ctx.axis, ctx.g), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, g, axis):
        ctx.g, ctx.axis = g, axis
        return _scatter_noted(tensor, axis, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather_noted(grad, ctx.axis, ctx.g), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, g, axis):
        ctx.g, ctx.axis = g, axis
        return _gather_noted(tensor, axis, g)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.axis, ctx.g), None, None


class _ScatterToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, g, axis):
        ctx.g, ctx.axis = g, axis
        return _block(tensor, axis, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather_noted(grad, ctx.axis, ctx.g), None, None


def all_gather_autograd(tensor, axis=0, group: Optional[Group] = None):
    """`all_gather_concat` whose backward is the sum-reduce-scatter of the
    gradient (the reference's tiled all_gather and its transpose)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _AllGather.apply(tensor, g, axis)


def reduce_scatter_autograd(tensor, axis=0, group: Optional[Group] = None):
    """The sum-`reduce_scatter` whose backward is the all-gather of the
    gradient (the reference's tiled psum_scatter and its transpose)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _ReduceScatter.apply(tensor, g, axis)


def gather_replicated_autograd(tensor, axis=-1,
                               group: Optional[Group] = None):
    """`all_gather_concat` along `axis` for a caller whose every rank then
    computes the same function of the whole (a tensor-parallel layer's
    gathered output, a sequence-parallel model's output): the cotangent
    is the same on every rank, and the backward keeps this rank's slice
    of it (the sum all_gather_autograd's backward takes would count it
    nranks times). No group (None) is the identity."""
    if group is None:
        return tensor
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _GatherReplicated.apply(tensor, g, axis)


def scatter_to_model_parallel(tensor, axis=-1,
                              group: Optional[Group] = None):
    """This rank's contiguous block of `tensor` along `axis` (a replicated
    input of a row-parallel product); the backward all-gathers the
    gradient. No group (None) is the identity."""
    if group is None:
        return tensor
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _ScatterToModelParallel.apply(tensor, g, axis)


# -- Megatron-style split (reference paddle_tpu/distributed/collective.py
# :437-471, Paddle's distributed/collective.py split) -------------------

_split_layer_cache: dict = {}


def split(x, size, operation="linear", axis=0, num_partitions=None,
          gather_out=True, weight_attr=None, bias_attr=None, name=None):
    """A linear or an embedding partitioned over the model-parallel group
    (the current mesh's mp axis): `size` is the WHOLE (in, out) shape
    ((vocab, hidden) for "embedding"); "linear" with axis 0 partitions
    the weight's rows (a RowParallelLinear, its input taken whole and
    split here), axis 1 its columns (a ColumnParallelLinear, its output
    gathered unless `gather_out` is False). The layer is built on `x`'s
    device at the first call of a `name` (a default made from the
    arguments), with the reference's initialisation drawn whole from
    torch's default generator (Xavier-uniform linear weights, normal(0,
    0.02) embeddings, zero biases) and this rank's block kept, and
    reused by later calls of that name. `bias_attr=False` builds no
    bias; `weight_attr` and `num_partitions` are accepted for the
    reference's signature (the mesh sets the partitions)."""
    from .fleet import mp_layers
    from .mesh import full_shape, shard_block

    key = name or f"dist_split_{operation}_{axis}_{tuple(size)}"
    layer = _split_layer_cache.get(key)
    if layer is None:
        kw = dict(device=x.device)
        has_bias = bias_attr is not False
        if operation == "embedding":
            layer = mp_layers.VocabParallelEmbedding(int(size[0]),
                                                     int(size[1]), **kw)
        elif operation == "linear" and axis == 0:
            layer = mp_layers.RowParallelLinear(
                int(size[0]), int(size[1]), has_bias=has_bias,
                input_is_parallel=False, **kw)
        elif operation == "linear" and axis == 1:
            layer = mp_layers.ColumnParallelLinear(
                int(size[0]), int(size[1]), has_bias=has_bias,
                gather_output=gather_out, **kw)
        else:
            raise ValueError(
                f"split: unsupported operation={operation!r} axis={axis}")
        with torch.no_grad():
            for pname, p in layer.named_parameters():
                shape = full_shape(p)
                whole = torch.empty(shape, dtype=p.dtype, device=p.device)
                if pname == "bias":
                    whole.zero_()
                elif operation == "embedding":
                    whole.normal_(0.0, 0.02)
                else:
                    bound = (6.0 / (shape[0] + shape[1])) ** 0.5
                    whole.uniform_(-bound, bound)
                p.copy_(shard_block(whole, p))
        _split_layer_cache[key] = layer
    return layer(x)
