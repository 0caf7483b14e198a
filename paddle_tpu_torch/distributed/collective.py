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
an H100). `split` (the tensor-parallel linear) waits for the mp
layers (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = [
    "ReduceOp", "Group", "get_group", "new_group", "all_reduce",
    "all_gather", "all_gather_concat", "reduce_scatter", "broadcast",
    "reduce", "all_to_all", "alltoall", "alltoall_single", "gather",
    "scatter", "collective_permute", "send", "recv", "isend", "irecv",
    "P2POp", "batch_isend_irecv", "barrier", "get_rank", "get_world_size",
    "axis_context",
]


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
    `concat_axis` in rank order."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    outs = all_to_all([], list(torch.chunk(tensor, g.nranks,
                                           dim=split_axis)), group)
    return torch.cat(outs, dim=concat_axis)


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
    no pair ends here."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    me = g.rank
    out = torch.zeros_like(tensor)
    ops: List[P2POp] = []
    for s, d in perm:
        if s == me:
            ops.append(P2POp(isend, tensor.contiguous(), g.ranks[d], g))
        if d == me:
            ops.append(P2POp(irecv, out, g.ranks[s], g))
    if ops:
        for work in _p2p_works(ops):
            work.wait()
    return out
