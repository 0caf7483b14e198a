"""Pipeline-parallel schedule engines (counterpart of paddle_tpu/distributed/
pipeline.py; reference: Paddle's PipelineParallel forward_backward_pipeline,
fleet/meta_parallel/pipeline_parallel.py:382, and its interleaved schedule
:959).

The reference compiles the whole schedule into one SPMD program over the
'pp' mesh axis: a lax.scan of ticks, masked compute in the bubbles,
lax.ppermute handoffs and the backward recomputed from the stage input.
Here, as in Paddle's own PipelineParallel, one process a stage drives the
schedule from the host:

  * each rank of the pp group holds only its block of the reference's
    stacked stage parameters (leading dimension 1; V at interleave, in the
    reference's order i = r*V + v) and gets that block's gradient back;
  * every rank runs the reference's tick arithmetic exactly (`fwd_index` /
    `bwd_index` for 1F1B, `fwd_slot` / `bwd_slot` for interleave, the span
    T), so the order of work, the bubbles and the in-flight bound (at most
    S microbatches at V = 1) are the reference's; in a bubble slot a rank
    computes nothing, where the reference computes masked garbage;
  * the stage handoffs are collective.collective_permute over the pp
    group: the forward ring and the backward ring of every tick, issued by
    every rank in the same order, zeros from a rank with nothing to send
    (under gloo, CUDA tensors take collective.py's host route);
  * a forward slot keeps its microbatch's autograd graph until its
    backward slot, which runs torch.autograd.backward on the stage output
    with the received gradient (on the loss, seeded 1/M, at the last
    stage) and frees it: the stage forward is not recomputed;
  * the loss, the loss parameters' and shared parameters' gradients and
    d_xs are summed over the pp group once, at the end, each in place (the
    reference's psums).

F-then-B runs every forward slot, then the backward slots in reverse tick
order: the transpose jax AD gives the reference's forward scan.

Each engine takes the reference's arguments; `mesh` is the port's
(mesh.build_mesh(pp=S), or the one fleet.init sets) and `axis` names its
pp group. `stage_fn(params, x)` and `loss_fn(loss_params, y, label)` are
torch functions of pytrees of tensors. The backward passes run with amp's
auto_cast off, as TrainStep's do. NCCL handoffs (ranks on several cards)
are refused: they wait in ROADMAP queue 1 (NCCL, and stages on several
cards). `last_stats()` reports this rank's last run: ticks, slots
computed, idle ticks, the handoffs' calls, bytes, the ones that carried a
microbatch and their seconds, the end sum, compute seconds and the most
microbatch graphs held at once.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .collective import ReduceOp, all_reduce, collective_permute

__all__ = ["pipeline_1f1b", "pipeline_fthenb", "pipeline_interleave",
           "ENGINES", "last_stats", "rank_block"]

_LAST: dict = {}


def last_stats() -> dict:
    """This rank's counters of the last engine run (see the module note)."""
    return dict(_LAST)


def rank_block(stacked, rank: int, n_stages: int, n_virtual: int = 1):
    """Rank `rank`'s block of a stacked tree whose leaves have leading
    dimension S*V in the reference's order i = r*V + v: the rows
    [rank*V, (rank+1)*V), what P('pp') hands that rank."""
    lo, hi = rank * n_virtual, (rank + 1) * n_virtual
    return pytree.tree_map(lambda a: a[lo:hi], stacked)


def _pp_group(mesh, axis, n_stages):
    """This rank's group along `axis` (None at one stage and no mesh)."""
    from .mesh import get_mesh

    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or axis not in mesh.axis_names:
        if n_stages == 1:
            return None
        raise ValueError(f"pipeline of {n_stages} stages: no mesh with an "
                         f"axis {axis!r}")
    group = mesh.group(axis)
    if group.nranks != n_stages:
        raise ValueError(f"pipeline of {n_stages} stages over the "
                         f"{axis!r} axis of {group.nranks} ranks")
    if group.rank < 0:
        raise ValueError(f"this rank is not on the {axis!r} axis")
    pg = group.process_group
    if pg is not None:
        import torch.distributed as dist

        if dist.get_backend(pg) == "nccl":
            raise NotImplementedError(
                "pipeline handoffs over NCCL (stages on several cards) are "
                "not ported (ROADMAP queue 1: NCCL, and stages on several "
                "cards): run the pp group over gloo "
                "(PADDLE_DISTRI_BACKEND=gloo)")
    return group


def _leaf(t):
    """A fresh autograd leaf of `t`'s values that keeps `t`'s mp cut
    (`_mp_shard`, distributed/mesh.py): the mp layers find their group by
    it, also on the leaves functional_call swaps into them for a stage."""
    leaf = t.detach().requires_grad_(True)
    if hasattr(t, "_mp_shard"):
        leaf._mp_shard = t._mp_shard
    return leaf


def _leaves(tree):
    return pytree.tree_map(_leaf, tree)


def _grads(tree):
    return pytree.tree_map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
        tree)


def backward(outputs, grads) -> None:
    """torch.autograd.backward with amp's auto_cast off (the forward ran
    under it; a TrainStep's backward runs outside it)."""
    from ..amp import amp_state

    st = amp_state()
    enabled, st.enabled = st.enabled, False
    try:
        torch.autograd.backward(outputs, grads)
    finally:
        st.enabled = enabled


class _Run:
    """One rank's bookkeeping of an engine run: the in-flight graphs, the
    handoffs and the counters of last_stats()."""

    def __init__(self, group, device, schedule):
        self.group = group
        self.rank = group.rank if group is not None else 0
        self._sync = torch.cuda.synchronize if device.type == "cuda" \
            else None
        self.inflight = {}
        self.st = {"schedule": schedule, "ticks": 0, "idle_ticks": 0,
                   "fwd_slots": 0, "bwd_slots": 0, "permutes": 0,
                   "permute_bytes": 0, "carried": 0, "handoff_s": 0.0,
                   "fwd_s": 0.0, "bwd_s": 0.0, "sum_s": 0.0, "sum_bytes": 0,
                   "max_inflight": 0}

    def clock(self):
        if self._sync is not None:
            self._sync()
        return time.perf_counter()

    def hold(self, key, entry):
        self.inflight[key] = entry
        self.st["max_inflight"] = max(self.st["max_inflight"],
                                      len(self.inflight))

    def tick(self, busy):
        self.st["ticks"] += 1
        self.st["idle_ticks"] += not busy

    def permute(self, tensor, perm, carried):
        """collective_permute of `tensor` over the group, counted."""
        t0 = self.clock()
        out = collective_permute(tensor, perm, self.group)
        self.st["handoff_s"] += self.clock() - t0
        self.st["permutes"] += 1
        sends = sum(s == self.rank for s, _ in perm) \
            if self.group is not None and self.group.nranks > 1 else 0
        self.st["permute_bytes"] += sends * tensor.numel() \
            * tensor.element_size()
        self.st["carried"] += bool(carried and sends)
        return out

    def total(self, tensors):
        """Sum `tensors` over the group, in place, one all-reduce each in
        the order given (no flat copy of the tied ends' gradients)."""
        g = self.group
        if g is None or g.nranks <= 1:
            return list(tensors)
        t0 = self.clock()
        for t in tensors:
            all_reduce(t, ReduceOp.SUM, g)
            self.st["sum_bytes"] += t.numel() * t.element_size()
        self.st["sum_s"] += self.clock() - t0
        return list(tensors)

    def finish(self):
        _LAST.clear()
        _LAST.update(self.st)


def _input_leaf(x, need_grad):
    return x.detach().requires_grad_(True) if need_grad else x


def _ends(run, loss_acc, lp_leaves, gxs, extra=()):
    """The end-of-run sums over the pp group: (loss, d_loss tree, d_xs,
    the sums of `extra`)."""
    d_lp, spec = pytree.tree_flatten(_grads(lp_leaves))
    parts = [loss_acc] + list(extra) + d_lp + ([gxs] if gxs is not None
                                               else [])
    parts = run.total(parts)
    n = len(extra)
    loss, sums = parts[0], parts[1:1 + n]
    d_lp = parts[1 + n:1 + n + len(d_lp)]
    d_xs = parts[-1] if gxs is not None else None
    return loss, pytree.tree_unflatten(d_lp, spec), d_xs, sums


def _want_dxs(xs, need_dxs):
    return need_dxs and xs.is_floating_point()


def run_1f1b(stage_fn, loss_fn, group, n_stages, params, loss_params, xs,
             labels, need_dxs=True):
    """The 1F1B schedule on this rank; `params` is its stage's tree (not
    stacked). Returns (loss, d_params, d_loss_params, d_xs)."""
    S, M = n_stages, xs.shape[0]
    T = 2 * M + 2 * S - 3       # last tick: t_b(0, M-1) = 2(M-1) + 2(S-1)
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    bwd_perm = [(i + 1, i) for i in range(S - 1)]
    run = _Run(group, xs.device, "1F1B")
    r = run.rank
    first, last = r == 0, r == S - 1
    dxs = _want_dxs(xs, need_dxs)
    p, lp = _leaves(params), _leaves(loss_params)
    zeros = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    gxs = torch.zeros_like(xs) if dxs else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=xs.device)
    arrived, gbuf = {}, zeros

    def fwd_index(t, s):
        """Microbatch of stage s's forward substep at tick t, and whether
        the slot is live (warm-up m < S - s, then every other tick)."""
        m_warm = t - s
        if 0 <= m_warm < min(S - s, M):
            return m_warm, True
        num = t + 1 - s
        m = num // 2
        return m, num % 2 == 0 and S - s <= m < M

    def bwd_index(t, s):
        num = t - 2 * (S - 1) + s
        m = num // 2
        return m, num >= 0 and num % 2 == 0 and m < M

    for t in range(T):
        m_f, f_live = fwd_index(t, r)
        m_b, b_live = bwd_index(t, r)
        run.tick(f_live or b_live)
        y_send = zeros
        if f_live:
            t0 = run.clock()
            x = _input_leaf(xs[m_f], dxs) if first else \
                _input_leaf(arrived.pop(m_f), True)
            y = stage_fn(p, x)
            if last:
                out = loss_fn(lp, y, labels[m_f])
            else:
                out, y_send = y, y.detach().to(xs.dtype)
            run.hold(m_f, (x, out))
            run.st["fwd_slots"] += 1
            run.st["fwd_s"] += run.clock() - t0
        gx_send = zeros
        if b_live:
            t0 = run.clock()
            x, out = run.inflight.pop(m_b)
            if last:
                loss_acc = loss_acc + out.detach().float() / M
                backward(out, torch.full_like(out, 1.0 / M))
            else:
                backward(out, gbuf.to(out.dtype))
            if not first:
                gx_send = x.grad.to(xs.dtype)
            elif dxs:
                gxs[m_b] += x.grad.to(xs.dtype)
            del x, out
            run.st["bwd_slots"] += 1
            run.st["bwd_s"] += run.clock() - t0
        y_rot = run.permute(y_send, fwd_perm, f_live and not last)
        gbuf = run.permute(gx_send, bwd_perm, b_live and not first)
        m_in, in_live = fwd_index(t, r - 1)
        if in_live and r >= 1:
            arrived[m_in] = y_rot
    loss, d_lp, d_xs, _ = _ends(run, loss_acc, lp, gxs)
    run.finish()
    return loss, _grads(p), d_lp, d_xs if dxs else torch.zeros_like(xs)


def run_fthenb(stage_fn, loss_fn, group, n_stages, params, loss_params, xs,
               labels, need_dxs=True):
    """F-then-B on this rank: every forward slot, then the backward slots
    in reverse tick order. Returns (loss, d_params, d_loss_params, d_xs)."""
    S, M = n_stages, xs.shape[0]
    T = M + S - 1
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    bwd_perm = [(i + 1, i) for i in range(S - 1)]
    run = _Run(group, xs.device, "FThenB")
    r = run.rank
    first, last = r == 0, r == S - 1
    dxs = _want_dxs(xs, need_dxs)
    p, lp = _leaves(params), _leaves(loss_params)
    zeros = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    gxs = torch.zeros_like(xs) if dxs else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=xs.device)
    state = zeros
    for t in range(T):
        m = t - r
        live = 0 <= m < M
        run.tick(live)
        y_send = zeros
        if live:
            t0 = run.clock()
            x = _input_leaf(xs[m], dxs) if first else \
                _input_leaf(state, True)
            y = stage_fn(p, x)
            if last:
                out = loss_fn(lp, y, labels[m])
            else:
                out, y_send = y, y.detach().to(xs.dtype)
            run.hold(m, (x, out))
            run.st["fwd_slots"] += 1
            run.st["fwd_s"] += run.clock() - t0
        state = run.permute(y_send, fwd_perm, live and not last)
    g_send = zeros
    for t in reversed(range(T)):
        m = t - r
        live = 0 <= m < M
        # the transpose of tick t's handoff, then tick t's backward
        g_recv = run.permute(g_send, bwd_perm, g_send is not zeros)
        run.tick(live)
        g_send = zeros
        if live:
            t0 = run.clock()
            x, out = run.inflight.pop(m)
            if last:
                loss_acc = loss_acc + out.detach().float() / M
                backward(out, torch.full_like(out, 1.0 / M))
            else:
                backward(out, g_recv.to(out.dtype))
            if not first:
                g_send = x.grad.to(xs.dtype)
            elif dxs:
                gxs[m] += x.grad.to(xs.dtype)
            del x, out
            run.st["bwd_slots"] += 1
            run.st["bwd_s"] += run.clock() - t0
    loss, d_lp, d_xs, _ = _ends(run, loss_acc, lp, gxs)
    run.finish()
    return loss, _grads(p), d_lp, d_xs if dxs else torch.zeros_like(xs)


def _hidden_like(pre_fn, shared, xs):
    """The shape and dtype of the pipeline-carried microbatch: pre_fn's
    output on the first microbatch (run without a graph) or xs's rows."""
    if pre_fn is None:
        return xs.shape[1:], xs.dtype
    with torch.no_grad():
        h = pre_fn(shared, xs[0])
    return h.shape, h.dtype


def run_interleave(stage_fn, loss_fn, group, n_stages, n_virtual, chunks,
                   loss_params, xs, labels, pre_fn=None, post_fn=None,
                   shared_params=(), need_dxs=True):
    """The interleaved schedule on this rank; `chunks` is the list of its V
    chunks' trees (chunk v is global stage g = v*S + r). Returns (loss,
    [d_chunk], d_shared, d_loss_params, d_xs)."""
    S, V = n_stages, n_virtual
    D, M = S * V, xs.shape[0]
    # last tick: t_b(0, M-1) = t_f(0, M-1) + 2(D-1) + 1, exact for any M
    T = ((M - 1) % S) + S * V * ((M - 1) // S) + 2 * D
    ring_fwd = [(i, (i + 1) % S) for i in range(S)]
    ring_bwd = [(i, (i - 1) % S) for i in range(S)]
    run = _Run(group, xs.device, "Interleave")
    r = run.rank
    cs = [_leaves(c) for c in chunks]
    sh, lp = _leaves(shared_params), _leaves(loss_params)
    shape, hdtype = _hidden_like(pre_fn, sh, xs)
    dxs = _want_dxs(xs, need_dxs) and pre_fn is None
    zeros = torch.zeros(shape, dtype=hdtype, device=xs.device)
    gxs = torch.zeros_like(xs) if dxs else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=xs.device)
    h_recv = g_recv = zeros

    def fwd_slot(t):
        q = t - r
        b, p = q % S, q // S
        v, m = p % V, (p // V) * S + b
        return v, m, q >= 0 and 0 <= m < M

    def bwd_slot(t):
        q = t - D - (S - 1 - r)
        b, p = q % S, q // S
        v, m = (V - 1) - (p % V), (p // V) * S + b
        return v, m, q >= 0 and 0 <= m < M

    for t in range(T):
        v_f, m_f, f_live = fwd_slot(t)
        v_b, m_b, b_live = bwd_slot(t)
        run.tick(f_live or b_live)
        g_f, g_b = v_f * S + r, v_b * S + r
        y_send = zeros
        if f_live:
            t0 = run.clock()
            if g_f == 0 and pre_fn is not None:
                x = None
                h = pre_fn(sh, xs[m_f]).to(hdtype)
            else:
                x = _input_leaf(xs[m_f], dxs) if g_f == 0 else \
                    _input_leaf(h_recv, True)
                h = x
            y = stage_fn(cs[v_f], h)
            if g_f == D - 1:
                logits = post_fn(sh, y) if post_fn is not None else y
                out = loss_fn(lp, logits, labels[m_f]).float()
            else:
                out, y_send = y, y.detach().to(hdtype)
            run.hold((v_f, m_f), (x, out))
            run.st["fwd_slots"] += 1
            run.st["fwd_s"] += run.clock() - t0
        gx_send = zeros
        if b_live:
            t0 = run.clock()
            x, out = run.inflight.pop((v_b, m_b))
            if g_b == D - 1:
                loss_acc = loss_acc + out.detach() / M
                backward(out, torch.full_like(out, 1.0 / M))
            else:
                backward(out, g_recv.to(out.dtype))
            if g_b > 0:
                gx_send = x.grad.to(hdtype)
            elif dxs:
                gxs[m_b] += x.grad.to(xs.dtype)
            del x, out
            run.st["bwd_slots"] += 1
            run.st["bwd_s"] += run.clock() - t0
        h_recv = run.permute(y_send, ring_fwd, f_live and g_f < D - 1)
        g_recv = run.permute(gx_send, ring_bwd, b_live and g_b > 0)
    d_sh, sh_spec = pytree.tree_flatten(_grads(sh))
    loss, d_lp, d_xs, d_sh = _ends(run, loss_acc, lp, gxs, d_sh)
    run.finish()
    return (loss, [_grads(c) for c in cs],
            pytree.tree_unflatten(d_sh, sh_spec), d_lp,
            d_xs if dxs else torch.zeros_like(xs))


def _chunk(block, v):
    return pytree.tree_map(lambda a: a[v], block)


def _stack(chunks):
    leaves = [pytree.tree_flatten(c)[0] for c in chunks]
    spec = pytree.tree_flatten(chunks[0])[1]
    return pytree.tree_unflatten(
        [torch.stack(ts) for ts in zip(*leaves)], spec)


def _check_block(stage_params, n):
    for a in pytree.tree_leaves(stage_params):
        if a.shape[0] != n:
            raise ValueError(f"stage_params: this rank's block has leading "
                             f"dimension {a.shape[0]}, expected {n}")


def pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, mesh, n_stages: int,
                  stage_params: Any, loss_params: Any, xs: torch.Tensor,
                  labels: torch.Tensor, axis: str = "pp"):
    """Run the 1F1B schedule; returns (loss, d_stage_params, d_loss_params,
    d_xs).

    stage_fn(params, x) -> y        with y.shape == x.shape (homogeneous)
    loss_fn(loss_params, y, label) -> scalar mean loss of one microbatch
    stage_params: this rank's block of the stacked tree (leading dim 1)
    xs, labels: leading dim M = number of microbatches, whole on every rank
    d_stage_params is the rank's block; the rest are whole on every rank.
    """
    group = _pp_group(mesh, axis, n_stages)
    _check_block(stage_params, 1)
    loss, d_p, d_lp, d_xs = run_1f1b(
        stage_fn, loss_fn, group, n_stages, _chunk(stage_params, 0),
        loss_params, xs, labels)
    return loss, _stack([d_p]), d_lp, d_xs


def pipeline_fthenb(stage_fn: Callable, loss_fn: Callable, mesh,
                    n_stages: int, stage_params: Any, loss_params: Any,
                    xs: torch.Tensor, labels: torch.Tensor, axis: str = "pp"):
    """F-then-B engine (GPipe; the reference's forward scan and its jax AD
    transpose): the arguments and returns of pipeline_1f1b."""
    group = _pp_group(mesh, axis, n_stages)
    _check_block(stage_params, 1)
    loss, d_p, d_lp, d_xs = run_fthenb(
        stage_fn, loss_fn, group, n_stages, _chunk(stage_params, 0),
        loss_params, xs, labels)
    return loss, _stack([d_p]), d_lp, d_xs


def pipeline_interleave(stage_fn: Callable, loss_fn: Callable, mesh,
                        n_stages: int, stage_params: Any, loss_params: Any,
                        xs: torch.Tensor, labels: torch.Tensor,
                        axis: str = "pp", n_virtual: int = 1,
                        pre_fn: Optional[Callable] = None,
                        post_fn: Optional[Callable] = None,
                        shared_params: Any = None):
    """Interleaved virtual-stage schedule. D = S*V global stages; global
    stage g = v*S + r runs on rank r as its chunk v, and `stage_params` is
    this rank's block of the stacked tree, leading dimension V (chunk v at
    row v: the reference's rows r*V + v).

      t_f(g, m) = (m % S) + S*V*(m // S) + g
      t_b(g, m) = t_f(g, m) + 2*(D - 1 - g) + 1

    Every activation and gradient is consumed one tick after it is made,
    so the ring handoff's arrival is the next slot's operand.
    pre_fn(shared, raw_x) -> h runs before stage 0; post_fn(shared, y) ->
    logits before the loss at stage D-1; both read `shared_params`, whose
    gradient is summed over the pp group (the reference's tied ends).

    Returns (loss, d_stage_params, d_shared, d_loss_params, d_xs)."""
    group = _pp_group(mesh, axis, n_stages)
    _check_block(stage_params, n_virtual)
    shared = () if shared_params is None else shared_params
    loss, d_cs, d_sh, d_lp, d_xs = run_interleave(
        stage_fn, loss_fn, group, n_stages, n_virtual,
        [_chunk(stage_params, v) for v in range(n_virtual)], loss_params,
        xs, labels, pre_fn, post_fn, shared)
    return loss, _stack(d_cs), d_sh, d_lp, d_xs


ENGINES = {"1F1B": pipeline_1f1b, "FThenB": pipeline_fthenb,
           "Interleave": pipeline_interleave}
