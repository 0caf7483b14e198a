"""Reduce schedules that overlap the backward: the ring all-reduce, the
per-bucket cost model, and the hook trigger that issues each bucket's
reduction as soon as its gradients are ready (counterpart of
paddle_tpu/distributed/overlap.py).

The reference lowers each bucket's all-reduce to a chunked ring
reduce-scatter then all-gather of `ppermute` steps, traces the backward
to a jaxpr, finds the earliest equation after which each bucket's
gradients exist, and replays the backward equation by equation with the
ring steps emitted in between (`overlap_grad_reduce`, `_replay_eqn`).
Nothing of that replay ports: PyTorch runs the backward eagerly, so the
port triggers from the backward itself (`BucketTrigger`):

  * each trainable parameter gets a `register_post_accumulate_grad_hook`
    for the step's backward; its call marks the parameter ready and
    counts one position (the port's counterpart of an equation index);
  * buckets are issued in bucket order (0 first, the last parameters),
    each as soon as it and every earlier bucket are ready, so every rank
    issues its collectives in one order whatever order its hooks ran in;
    a bucket is one asynchronous all-reduce (`async_op=True`), or, under
    dp_overlap="fine" when `choose_schedule` says "ring", a `_RingReduce`
    whose first exchange starts at once;
  * later hooks pump the open rings: a ring takes its next step every
    `stride` positions (the reference's stride over equations), each
    step the completion of one exchange and the start of the next;
  * whatever is still open drains after the backward, before the clip.

Hooks were chosen over a post-backward pass (no overlap at all) and over
autograd graph inspection (the readiness the reference computes from its
jaxpr is what the hooks observe directly, for the graph that actually
ran). The cost model's "segments remaining" is the number of hooks still
to come after the bucket's last member in reversed parameter order,
which every rank computes alike; a bucket's schedule never depends on
when a rank's hook happened to run. `last_schedule()` records, in place
of the reference's equation indices, each bucket's readiness position
(the hook count at which it was issued), its schedule, and the ring
steps taken inline (pumped during the backward) against those drained
after it.

A ring step is one `batch_isend_irecv` to the ring's neighbours, tagged
with the bucket's index so concurrent rings stay apart; the ring sums in
ring order, which differs from the all-reduce's order, so results are
allclose at dtype tolerance, as the reference's are. Gloo cannot send a
CUDA tensor (collective._check_p2p raises), so on a card the ring needs
nccl; under gloo the cost model never picks it at world <= 2.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..core.flags import define_flag, get_flag
from ..observability.registry import counter as _obs_counter
from ..observability.registry import gauge as _obs_gauge
from ..observability.spans import span as _span
from .grad_buckets import (_BUCKETS, _FLUSHES, _group_of, coalesce,
                           default_bucket_bytes, partition_buckets,
                           uncoalesce)

define_flag(
    "dp_overlap", "bucketed",
    "Data-parallel gradient reduction schedule for TrainStep(dp_axis=...): "
    "'bucketed' = one all-reduce per fixed-byte bucket, issued from the "
    "gradient hooks (grad_buckets.py); 'fine' = each bucket large enough "
    "decomposed into a ring reduce-scatter/all-gather whose steps the "
    "later hooks advance (allclose parity; see distributed/overlap.py).")
define_flag(
    "dp_overlap_min_kb", 128,
    "Per-bucket byte floor (KB) below which the fine-grained schedule "
    "keeps one all-reduce for that bucket: a ring pays 2*(world-1) "
    "exchanges and loses on small buckets.")

_RING_STEPS = _obs_counter(
    "overlap_ring_steps_total",
    "Ring all-reduce exchanges completed by the fine-grained schedule.")
_RING_BUCKETS = _obs_gauge(
    "overlap_ring_buckets",
    "Buckets reduced by a ring in the most recent fine schedule.")
_PSUM_BUCKETS = _obs_gauge(
    "overlap_psum_buckets",
    "Buckets kept on one all-reduce in the most recent fine schedule.")

_LAST_SCHEDULE: Optional[Dict[str, Any]] = None


def last_schedule() -> Optional[Dict[str, Any]]:
    """Stats of this process's most recent hooked reduction: mode, bucket
    count, each bucket's schedule and readiness position, ring steps
    inline against drained."""
    return None if _LAST_SCHEDULE is None else dict(_LAST_SCHEDULE)


def min_ring_bytes() -> int:
    return int(get_flag("dp_overlap_min_kb")) << 10


def choose_schedule(nbytes: int, world: int, eqns_remaining: int,
                    min_bytes: Optional[int] = None) -> str:
    """Per-bucket cost model, the reference's: 'ring' or 'psum'. A ring
    pays 2*(world-1) exchanges, so small buckets lose to one all-reduce;
    a bucket with little backward left to overlap must clear 4x the
    floor; at world <= 2 a ring is the all-reduce's own exchange."""
    if min_bytes is None:
        min_bytes = min_ring_bytes()
    if world <= 2:
        return "psum"
    floor = min_bytes if eqns_remaining >= 2 * (world - 1) else 4 * min_bytes
    return "ring" if nbytes >= floor else "psum"


# ---------------------------------------------------------------------------
# staged ring all-reduce
# ---------------------------------------------------------------------------

class _RingReduce:
    """Ring reduce-scatter then all-gather of one flat vector over a group,
    2*(world-1) exchanges with the ring's neighbours. `start()` begins the
    first exchange; each `step()` completes the one in flight, folds in
    what arrived and starts the next; `finish()` drains the rest and
    returns the reduced (mean) vector: `flat` itself, written in place,
    when its length splits evenly into `world` chunks.

    Chunk j of the vector is row j of a [world, chunk] view. After round
    r of the reduce-scatter this rank holds chunk (idx - r) summed over
    ranks idx-r..idx, as the reference's `_RingReduce` does, so both add
    in one order."""

    def __init__(self, flat: torch.Tensor, group, mean: bool = True,
                 tag: int = 0):
        import torch.distributed as dist

        from .collective import _check_p2p

        _check_p2p(flat, group.process_group)
        self._dist = dist
        self.group = group
        self.world = int(group.nranks)
        self.mean = mean
        self.tag = int(tag)
        self.flat = flat
        self.size = int(flat.numel())
        w = self.world
        pad = (-self.size) % w
        buf = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
        self.stack = buf.view(w, -1)
        self.idx = group.rank
        self._next = group.ranks[(self.idx + 1) % w]
        self._prev = group.ranks[(self.idx - 1) % w]
        self.acc = self.stack[self.idx].clone()
        self.cur = None
        self.total_steps = 2 * (w - 1)
        self._s = 0                 # exchanges completed
        self._inflight = None       # (works, receive buffer)

    @property
    def done(self) -> bool:
        return self._s >= self.total_steps

    def _exchange(self, send: torch.Tensor) -> None:
        dist = self._dist
        pg = self.group.process_group
        recv = torch.empty_like(send)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._next, group=pg, tag=self.tag),
            dist.P2POp(dist.irecv, recv, self._prev, group=pg, tag=self.tag)])
        self._inflight = (works, recv)

    def start(self) -> "_RingReduce":
        if self.total_steps and self._inflight is None and self._s == 0:
            self._exchange(self.acc)
        return self

    def step(self) -> None:
        """Complete the exchange in flight and start the next one."""
        if self.done:
            return
        if self._inflight is None:
            self.start()
        works, recv = self._inflight
        for work in works:
            work.wait()
        s, w = self._s, self.world
        self._s += 1
        if s < w - 1:
            # reduce-scatter round s + 1: what arrived, plus this rank's
            # copy of the same chunk
            self.acc = recv + self.stack[(self.idx - (s + 1)) % w]
            if s == w - 2:
                # this rank now owns chunk idx + 1, fully reduced
                if self.mean:
                    self.acc = self.acc / w
                self.cur = self.acc
            send = self.acc
        else:
            # all-gather round g: what arrived came g + 1 hops back, the
            # reduced chunk idx - g
            g = s - (w - 1)
            if g == 0:
                self.stack[(self.idx + 1) % w].copy_(self.cur)
            self.stack[(self.idx - g) % w].copy_(recv)
            send = self.cur = recv
        _RING_STEPS.inc()
        self._inflight = None
        if not self.done:
            self._exchange(send)

    def finish(self) -> torch.Tensor:
        while not self.done:
            self.step()
        out = self.stack.view(-1)
        if out.data_ptr() != self.flat.data_ptr():
            self.flat.copy_(out[:self.size])
        return self.flat


def ring_all_reduce(x, axis_name, world: Optional[int] = None,
                    mean: bool = True):
    """Decomposed all-reduce of one tensor over the group of `axis_name`
    (a mesh axis or a Group), all 2*(world-1) ring steps back to back.
    Returns a new tensor; allclose to the all-reduce at dtype tolerance."""
    group = _group_of(axis_name)
    if world is None:
        world = group.nranks
    if world <= 1 or group.rank < 0 or group.process_group is None:
        return x
    flat = x.detach().reshape(-1).clone()
    return _RingReduce(flat, group, mean=mean).start().finish() \
        .view(x.shape)


def reduce_flush(g_vals, axis_name, bucket_bytes: Optional[int] = None,
                 mean: bool = True, mode: str = "fine"):
    """Flush-style reduction of a gradient list with the per-bucket cost
    model applied but no overlap (every bucket back to back, the
    schedule chosen as if no backward were left). TrainStep's comm-only
    reduce probe times it; tests use it for parity without a backward.
    `mode='bucketed'` is grad_buckets.bucket_reduce. Buckets whose members
    lie back to back in memory are reduced in place."""
    from .collective import ReduceOp, all_reduce
    from .grad_buckets import bucket_reduce

    if mode != "fine":
        return bucket_reduce(g_vals, axis_name, bucket_bytes, mean=mean)
    if bucket_bytes is None:
        bucket_bytes = default_bucket_bytes()
    group = _group_of(axis_name)
    world = group.nranks
    shapes = [tuple(g.shape) for g in g_vals]
    out: List[Any] = [None] * len(g_vals)
    for idxs in partition_buckets(shapes, [g.dtype for g in g_vals],
                                  bucket_bytes):
        flat = coalesce(g_vals, idxs)
        nbytes = flat.numel() * flat.element_size()
        if choose_schedule(nbytes, world, eqns_remaining=0) == "ring" \
                and group.rank >= 0 and group.process_group is not None:
            red = _RingReduce(flat, group, mean=mean).start().finish()
        else:
            red = all_reduce(flat, ReduceOp.SUM, group)
            if mean and world > 1 and group.rank >= 0:
                red.div_(world)
        uncoalesce(red, idxs, shapes, out)
    return out


# ---------------------------------------------------------------------------
# the hook trigger
# ---------------------------------------------------------------------------

class _Grads:
    """params[i].grad by index, without building the list."""

    __slots__ = ("params",)

    def __init__(self, params):
        self.params = params

    def __getitem__(self, i):
        return self.params[i].grad


class BucketTrigger:
    """Issue each gradient bucket's reduction from the backward's
    post-accumulate hooks (see the module note). Built once for a
    parameter list, a group, a bucket size and a mode ('bucketed' or
    'fine'); `run(backward)` arms the hooks for one backward, calls it,
    removes them and drains, leaving every parameter's `.grad` reduced
    (mean over the group by default). A parameter the backward did not
    reach gets a zero gradient first, as the reference's step gives it.
    Every rank must run it for the same step."""

    def __init__(self, params, group, bucket_bytes: int, mode: str,
                 mean: bool = True):
        self.params = list(params)
        self.group = group
        self.world = int(group.nranks)
        self.mode = mode
        self.mean = mean
        self.shapes = [tuple(p.shape) for p in self.params]
        self.buckets = partition_buckets(
            self.shapes, [p.dtype for p in self.params], bucket_bytes)
        self.bucket_of = {i: b for b, idxs in enumerate(self.buckets)
                          for i in idxs}
        self._grads = _Grads(self.params)

    def _reset(self):
        self._pending = [len(idxs) for idxs in self.buckets]
        self._issued = 0
        self._pos = 0
        self._open: List[Dict[str, Any]] = []     # buckets in flight
        self._rings: List[Dict[str, Any]] = []    # of which rings
        self._stats: Dict[str, Any] = {
            "mode": self.mode, "world": self.world,
            "n_hooks": len(self.params), "n_buckets": len(self.buckets),
            "ring_buckets": 0, "psum_buckets": 0, "ring_steps_total": 0,
            "inline_steps": 0, "drained_steps": 0, "buckets": []}

    def _issue(self, b: int) -> None:
        with _span("dist.bucket_flush", cat="dist",
                   args={"tensors": len(self.buckets[b])}):
            _FLUSHES.inc()
            self._issue_one(b)

    def _issue_one(self, b: int) -> None:
        import torch.distributed as dist

        idxs = self.buckets[b]
        for i in idxs:
            p = self.params[i]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = coalesce(self._grads, idxs)
        nbytes = flat.numel() * flat.element_size()
        # the hooks still to come after this bucket's last member in the
        # reversed order, alike on every rank
        remaining = min(idxs)
        schedule = "psum" if self.mode != "fine" else \
            choose_schedule(nbytes, self.world, remaining)
        self._stats["buckets"].append({
            "bucket": b, "tensors": len(idxs), "bytes": nbytes,
            "ready_at": self._pos, "hooks_remaining": remaining,
            "schedule": schedule})
        ent = {"b": b, "idxs": idxs, "flat": flat}
        if schedule == "ring":
            self._stats["ring_buckets"] += 1
            ring = _RingReduce(flat, self.group, mean=self.mean, tag=b)
            self._stats["ring_steps_total"] += ring.total_steps
            ent.update(ring=ring.start(), next=self._pos + 1,
                       stride=max(1, remaining // (ring.total_steps + 1)))
            self._rings.append(ent)
        else:
            self._stats["psum_buckets"] += 1
            pg = self.group.process_group
            ent["work"] = None if pg is None else dist.all_reduce(
                flat, op=dist.ReduceOp.SUM, group=pg, async_op=True)
        self._open.append(ent)

    def _pump(self) -> None:
        for ent in self._rings:
            if self._pos >= ent["next"]:
                ent["ring"].step()
                self._stats["inline_steps"] += 1
                ent["next"] = self._pos + ent["stride"]
        self._rings = [e for e in self._rings if not e["ring"].done]

    def _hook(self, i: int):
        def ready(_param):
            self._pos += 1
            self._pending[self.bucket_of[i]] -= 1
            while self._issued < len(self.buckets) and \
                    self._pending[self._issued] == 0:
                self._issue(self._issued)
                self._issued += 1
            self._pump()
        return ready

    def _drain(self) -> None:
        while self._issued < len(self.buckets):
            self._issue(self._issued)
            self._issued += 1
        for ent in self._open:
            ring = ent.get("ring")
            if ring is not None:
                self._stats["drained_steps"] += \
                    ring.total_steps - ring._s
                red = ring.finish()
            else:
                red = ent["flat"]
                if ent["work"] is not None:
                    ent["work"].wait()
                    if self.mean:
                        red.div_(self.world)
            if red.data_ptr() != self._grads[min(ent["idxs"])].data_ptr():
                views = [None] * len(self.params)
                uncoalesce(red, ent["idxs"], self.shapes, views)
                for i in ent["idxs"]:
                    self.params[i].grad.copy_(views[i])
        self._open, self._rings = [], []

    def run(self, backward) -> None:
        global _LAST_SCHEDULE
        self._reset()
        _BUCKETS.set(len(self.buckets))
        handles = [p.register_post_accumulate_grad_hook(self._hook(i))
                   for i, p in enumerate(self.params)]
        try:
            backward()
        finally:
            for h in handles:
                h.remove()
        self._drain()
        if self.mode == "fine":
            _RING_BUCKETS.set(self._stats["ring_buckets"])
            _PSUM_BUCKETS.set(self._stats["psum_buckets"])
        _LAST_SCHEDULE = self._stats
