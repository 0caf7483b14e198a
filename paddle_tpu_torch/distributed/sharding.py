"""ZeRO group-sharded training (counterpart of paddle_tpu/distributed/
sharding.py; reference: Paddle's group_sharded_parallel, levels "os",
"os_g" and "p_g_os", GroupShardedOptimizerStage2 and GroupShardedStage3).

The reference makes each stage a placement over the mesh's `sharding`
axis and lets XLA derive the collectives. The port has no GSPMD: each
sharding rank is a process, and the stage says what a rank keeps between
steps. In every stage the sharding axis is a data axis, as in Paddle:

  * a TrainStep call takes the global batch and keeps this rank's rows
    (over dp x sharding, dp outermost);
  * after the backward the gradients are averaged over the axis by a
    reduce-scatter (with dp, the shard is then all-reduced over dp; the
    sum is divided by dp x sharding), so each rank holds its shard of
    the averaged gradient;
  * AdamW updates only that shard, one launch of the fused kernel a step
    and group (its master form under amp O2);
  * at "os" and "os_g" the updated shards are all-gathered into every
    rank's parameters; at "p_g_os" each unit's parameters are gathered
    where they are used.

Between steps a rank holds, at W sharding ranks and N fp32 parameters:
"os" all parameters and gradients and 1/W of m and v (8N + 8N/W bytes),
"os_g" 1/W of the gradients too (4N + 12N/W), "p_g_os" 1/W of everything
(16N/W).

The partition. Each AdamW group (optimizer/optimizers.py: one dtype,
device and decay setting) lays its parameters out in one parameter-major
flat order, cut into units: at "os" and "os_g" one unit, the whole group;
at "p_g_os" the model's units (below). Each unit's span is padded with
zeros to a multiple of W x ALIGN elements and cut into W equal chunks.
Rank r owns chunk r of every unit, and its shard buffers (gradient, m, v
and, under O2, the master) are its chunks end to end. A contiguous range
keeps the exchanges straight calls on flat buffers (collective
`reduce_scatter_flat` of a gradient span, `all_gather_flat` into a
parameter span, in place at "os" and "os_g", where every parameter stays
a view of its group's span) and the update one launch. Per-parameter
ownership along dimension 0, the reference's placement at W = 2 and the
rank-sharded checkpoint's rows, would need buffers laid out rank-major,
which no parameter view can address. The cost falls on the checkpoint: a
parameter cut in the middle is gathered leaf by leaf before its rows are
written (`_Sharded.rows`). Padding has zero gradient and zero state, so
AdamW leaves it at 0 (the decay of a zero is zero).

Stage 3 ("p_g_os"). A unit's parameters are views of one buffer whose
storage is freed (resized to 0) while the unit is not in use, so every
autograd record of a parameter stays valid. A model declares its units
with `zero_units()`, in forward order: a list of (modules, enter, exit,
borrow), the unit's parameters being the modules', used from the start
of `enter`'s forward to the end of `exit`'s, and gathering too the
earlier units whose indices `borrow` lists (a tied head: the
embeddings). GPT and Llama declare theirs (the embeddings, each block,
the final norm with the head). For another model a unit is each child
module, a ModuleList's or ModuleDict's children in its place (such a
container runs no forward), and one more is the rest of the model's
parameters; a model whose layers sit inside a wrapper module, or that
uses a parameter outside the forward of its module, declares its units.
A unit is gathered before its forward and released after it; hooks on
its outputs gather it again before its backward; once every parameter of
the unit has its gradient (post-accumulate hooks), the unit's gradient
span is reduce-scattered into the shard and the unit released.
`live_bytes` counts the parameters' gathered bytes (not a unit's
gradient span in its backward), and `peak_bytes` its peak since
`begin_step`. Under amp O1 autocast's bf16 casts of the weights, 2 bytes
a parameter, are what the linear layers save for the backward: releasing
the fp32 gather does not free them (ROADMAP).

Refused, naming themselves: `offload`, `sync_buffers`, `buffer_max_size`,
`sync_comm`, `segment_size`, a `dp_group` other than the mesh's dp group,
and a sharding axis beside an mp, sep, pp or ep axis of more than one
rank.
"""
from __future__ import annotations

import contextlib
import time

import torch

from . import collective as _coll
from .mesh import get_mesh
from .sharding_utils import (refuse_zero_beside, shard_batch,
                             shard_model_parameters)

__all__ = ["group_sharded_parallel", "zero_state_sharding",
           "zero_grad_sharding", "save_group_sharded_model", "ALIGN"]

_LEVELS = ("os", "os_g", "p_g_os")
ALIGN = 64          # elements: every rank's chunk of a unit is a multiple
_LOW = (torch.bfloat16, torch.float16)


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=None, segment_size=None,
                           sync_comm=False, dp_group=None):
    """Shard `optimizer` (the port's AdamW, or fleet's wrapper of it) and,
    at "p_g_os", `model`'s parameters over the current mesh's sharding
    axis (`group`'s axis when it names one); returns (model, optimizer,
    scaler) as the reference. Call it before the optimizer's first step:
    it builds the sharded flat buffers now. The data axes are the mesh's
    dp and the sharding axis: a `dp_group` other than the mesh's dp
    group raises, as do the reference's arguments that are not ported."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    for name, value, off in (("offload", offload, False),
                             ("sync_buffers", sync_buffers, False),
                             ("buffer_max_size", buffer_max_size, None),
                             ("sync_comm", sync_comm, False),
                             ("segment_size", segment_size, None)):
        if value != off:
            raise NotImplementedError(
                f"group_sharded_parallel({name}={value!r}) is not ported "
                "(ROADMAP queue 1: what ZeRO still lacks)")
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("group_sharded_parallel needs a device mesh "
                           "(distributed.set_mesh / fleet.init first)")
    axis = (group.axis_name if group is not None and group.axis_name
            else "sharding")
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    if dp_group is not None and \
            list(dp_group.ranks) != list(mesh.group("dp").ranks):
        raise NotImplementedError(
            f"group_sharded_parallel(dp_group=) of ranks {dp_group.ranks}: "
            "the data-parallel group is the mesh's dp axis, ranks "
            f"{mesh.group('dp').ranks} here (ROADMAP queue 1: what ZeRO "
            "still lacks)")
    refuse_zero_beside(mesh, axis)
    from ..optimizer.optimizers import AdamW

    inner = getattr(optimizer, "_inner", optimizer)
    if not isinstance(inner, AdamW):
        raise NotImplementedError(
            f"ZeRO shards AdamW's flat buffers; {type(inner).__name__} is "
            "not ported")
    if inner._groups is not None:
        raise RuntimeError("group_sharded_parallel must come before the "
                           "optimizer's first step")
    shard_model_parameters(model, mesh)
    inner._zero = zero = _Zero(level, mesh, axis)
    zero.attach(model, inner)
    return model, optimizer, scaler


def _zero_of(optimizer):
    return getattr(optimizer, "_zero", None)


def zero_state_sharding(optimizer, params):
    """Per parameter, the [start, stop) range of its flattened elements
    whose optimizer state this rank holds (empty when none); None without
    ZeRO. Every stage shards the state."""
    zero = _zero_of(optimizer)
    if zero is None:
        return None
    return [zero.owned(p) for p in params]


def zero_grad_sharding(optimizer, params):
    """As zero_state_sharding, for the gradients between steps: None at
    "os" (every rank keeps the whole gradient buffer) and without ZeRO."""
    zero = _zero_of(optimizer)
    if zero is None or zero.level == "os":
        return None
    return [zero.owned(p) for p in params]


def save_group_sharded_model(model, output, optimizer=None,
                             async_save=False):
    """The reference's save_group_sharded_model: every rank of the world
    writes its rows of the model's (and the optimizer's) state under
    `output` (distributed/checkpoint.py save_model_sharded)."""
    from .checkpoint import save_model_sharded

    save_model_sharded(model, output, optimizer=optimizer,
                       async_save=async_save)


class _Unit:
    """Some of one group's parameters, laid out end to end: their span is
    padded to a multiple of world x ALIGN elements and cut into `world`
    chunks of `chunk`; this rank's chunk sits at `local` in the group's
    shard buffers. At "p_g_os", `buf` holds the gathered span (storage
    freed while `refs` is 0) and `grad` its gradient in the unit's
    backward."""

    def __init__(self, group, params, world, local):
        self.group, self.params, self.local = group, params, local
        self.bounds, off = [], 0
        for p in params:
            self.bounds.append((off, off + p.numel()))
            off += p.numel()
        step = world * ALIGN
        self.padded = max(step, -(-off // step) * step)
        self.chunk = self.padded // world
        self.buf = self.grad = self.scope = None
        self.refs = 0
        self.done = set()

    def chunk_of(self, buf, rank):
        return buf[rank * self.chunk:(rank + 1) * self.chunk]

    def place(self, buf):
        """Copy the parameters into `buf` and make them its views."""
        for p, (a, b) in zip(self.params, self.bounds):
            buf[a:b].copy_(p.detach().reshape(-1))
            p.data = buf[a:b].view_as(p)

    def grad_views(self, buf):
        """Make every parameter's gradient a view of `buf` (its present
        gradient copied in, a missing one zero)."""
        for p, (a, b) in zip(self.params, self.bounds):
            view = buf[a:b].view_as(p)
            if p.grad is None:
                view.zero_()
            elif p.grad.data_ptr() != view.data_ptr():
                view.copy_(p.grad)
            p.grad = view


class _ShardGroup:
    """An AdamW group under ZeRO. `p`, `g`, `m`, `v` and `master` are this
    rank's shard buffers, so the optimizer's update runs over them as
    over a whole group (one launch). At "os" and "os_g" `full_p` is the
    group's whole parameter span (every parameter a view of it) and `p`
    its view of this rank's chunk; at "os" `full_g` the whole gradient
    span (`g` its chunk), at "os_g" it exists only between the backward
    and the reduce-scatter. At "p_g_os" `p` is a buffer of its own and
    each unit gathers from it."""

    sharded = True

    def __init__(self, zero, params, states, wd_on, multi_precision):
        p0 = params[0]
        has_master = multi_precision and p0.dtype in _LOW
        if p0.dtype != torch.float32 and not has_master:
            raise NotImplementedError(
                f"AdamW over {p0.dtype} parameters keeps fp32 master "
                "weights: pass multi_precision=True, or "
                "amp.decorate(model, optimizer, level='O2')")
        order = sorted(range(len(params)),
                       key=lambda i: zero.unit_of.get(id(params[i]), 0))
        self.zero, self.wd_on = zero, wd_on
        self.params = [params[i] for i in order]
        states = [states[i] for i in order]
        self.units, run = [], []
        for p in self.params:
            if run and zero.unit_of.get(id(p), 0) != \
                    zero.unit_of.get(id(run[0]), 0):
                self._add_unit(run)
                run = []
            run.append(p)
        self._add_unit(run)
        n = sum(u.chunk for u in self.units)
        dev, dtype, r = p0.device, p0.dtype, zero.rank
        self.m = torch.zeros(n, dtype=torch.float32, device=dev)
        self.v = torch.zeros(n, dtype=torch.float32, device=dev)
        self.full_p = self.full_g = None
        with torch.no_grad():
            if zero.level == "p_g_os":
                self.p = torch.empty(n, dtype=dtype, device=dev)
                for u in self.units:
                    u.buf = torch.zeros(u.padded, dtype=dtype, device=dev)
                    u.place(u.buf)
                    self.p[u.local:u.local + u.chunk].copy_(
                        u.chunk_of(u.buf, r))
                self.g = torch.zeros(n, dtype=dtype, device=dev)
            else:
                u = self.units[0]
                self.full_p = torch.zeros(u.padded, dtype=dtype, device=dev)
                u.place(self.full_p)
                self.p = u.chunk_of(self.full_p, r)
                if zero.level == "os":
                    self.full_g = torch.zeros_like(self.full_p)
                    u.grad_views(self.full_g)
                    self.g = u.chunk_of(self.full_g, r)
                else:
                    self.g = torch.zeros(n, dtype=dtype, device=dev)
            self.master = self.p.float() if has_master else None
        for p, st in zip(self.params, states):
            st["moment1"] = _Sharded(self, "m", p)
            st["moment2"] = _Sharded(self, "v", p)
            if has_master:
                st["master"] = _Sharded(self, "master", p)
        if zero.level == "p_g_os":
            for u in self.units:
                u.buf.untyped_storage().resize_(0)

    def _add_unit(self, params):
        local = sum(u.chunk for u in self.units)
        u = _Unit(self, params, self.zero.world, local)
        for p, (a, b) in zip(params, u.bounds):
            self.zero.where[id(p)] = (u, a, b)
        self.units.append(u)

    def adopt_grads(self):
        """The gradients reach the shard through the reduce-scatter
        (_Zero.reduce_gradients), not here."""

    def zero_grads(self):
        (self.full_g if self.full_g is not None else self.g).zero_()

    def buffer(self, kind):
        return {"p": self.p, "m": self.m, "v": self.v,
                "master": self.master}[kind]


class _Sharded:
    """One parameter's entry of a group's shard buffer `kind` ("p", "m",
    "v" or "master"), which the ranks hold in parts: `full()` gathers the
    whole (a collective every rank of the sharding group calls, in the
    same order), `rows(a, b)` the rows a rank-sharded checkpoint writes,
    `assign(value)` keeps this rank's part of a whole value. `shape` and
    `dtype` are the whole entry's."""

    def __init__(self, group, kind, param):
        self.group, self.kind, self.param = group, kind, param
        self.shape = tuple(param.shape)
        self.dtype = param.dtype if kind == "p" else torch.float32

    def full(self):
        return self.group.zero.gather(self.group.buffer(self.kind),
                                      self.param).view(self.shape)

    def rows(self, a, b):
        return self.full()[a:b]

    @torch.no_grad()
    def assign(self, value):
        self.group.zero.assign(self.group.buffer(self.kind), self.param,
                               value)


class _Scope:
    """Where a stage-3 unit is used: gathered from `enter`'s forward to
    the end of `exit`'s, and again for its backward. `params` are the
    ones it owns; `borrow` scopes whose units it gathers too (the tied
    head: the embeddings)."""

    def __init__(self, params, enter, exit, borrow=()):
        self.params, self.enter, self.exit = params, enter, exit
        self.borrow = list(borrow)
        self.units = []
        self.done = set()
        self.in_backward = False

    def all_units(self):
        return self.units + [u for s in self.borrow for u in s.units]


def _params(*modules):
    seen, out = set(), []
    for m in modules:
        for p in m.parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def _leaves(module):
    """`module`'s children, each container that never runs a forward of
    its own (ModuleList, ModuleDict) replaced by its children; parameter
    containers (ParameterList, ParameterDict) are left out: their
    parameters are used in the forward of the module that holds them."""
    for c in module.children():
        if isinstance(c, (torch.nn.ModuleList, torch.nn.ModuleDict)):
            yield from _leaves(c)
        elif not isinstance(c, (torch.nn.ParameterList,
                                torch.nn.ParameterDict)):
            yield c


def _scopes(model):
    """The stage-3 units of `model` (see the module note), as scopes: the
    ones `model.zero_units()` declares, else one for each of `_leaves`
    and one for the rest of the model's parameters (its own and its
    parameter containers'). A parameter that two scopes hold is the
    first's, and the second borrows it. A parameter of no scope raises."""
    declare = getattr(model, "zero_units", None)
    if declare is not None:
        scopes = []
        for mods, enter, exit, borrow in declare():
            scopes.append(_Scope(_params(*mods), enter, exit,
                                 [scopes[i] for i in borrow]))
    else:
        scopes = [_Scope(_params(c), c, c) for c in _leaves(model)]
        taken = {id(p) for s in scopes for p in s.params}
        scopes.append(_Scope([p for p in model.parameters()
                              if id(p) not in taken], model, model))
    owner = {}
    for s in scopes:
        mine = []
        for p in s.params:
            if id(p) in owner:
                if owner[id(p)] is not s and owner[id(p)] not in s.borrow:
                    s.borrow.append(owner[id(p)])
            else:
                owner[id(p)] = s
                mine.append(p)
        s.params = mine
    lost = [n for n, p in model.named_parameters() if id(p) not in owner]
    if lost:
        raise ValueError(f"ZeRO stage 3: {type(model).__name__}'s "
                         f"parameters {lost} lie in no unit")
    return [s for s in scopes if s.params or s.borrow]


class _Zero:
    """The ZeRO runtime of one optimizer (see the module note)."""

    def __init__(self, level, mesh, axis):
        self.level, self.mesh, self.axis = level, mesh, axis
        self.group = mesh.group(axis)
        if self.group.rank < 0:
            raise ValueError(f"this rank lies outside the mesh {mesh.shape}")
        self.rank, self.world = self.group.rank, self.group.nranks
        self.dp = mesh.group("dp")
        self.data_world = self.world * max(1, self.dp.nranks)
        self.unit_of, self.where = {}, {}
        self.scopes = []
        self.opt = None
        self.live_bytes = self.peak_bytes = 0
        self.seconds = {"gather": 0.0, "reduce_scatter": 0.0}

    # -- set-up ----------------------------------------------------------
    def attach(self, model, opt):
        self.opt = opt
        if self.level == "p_g_os":
            self.scopes = _scopes(model)
            for uid, s in enumerate(self.scopes):
                for p in s.params:
                    self.unit_of[id(p)] = uid
        model._zero = self
        opt._materialize_state()    # the groups, through make_group
        if self.level == "p_g_os":
            for g in opt._groups:
                for u in g.units:
                    u.scope = self.scopes[self.unit_of.get(id(u.params[0]),
                                                           0)]
                    u.scope.units.append(u)
            self._install()

    def make_group(self, params, states, wd_on, multi_precision):
        return _ShardGroup(self, params, states, wd_on, multi_precision)

    @property
    def groups(self):
        return self.opt._groups

    def owned(self, p):
        """[start, stop) of p's flattened elements in this rank's chunk."""
        u, a, b = self.where[id(p)]
        lo = max(a, self.rank * u.chunk)
        hi = min(b, (self.rank + 1) * u.chunk)
        return (lo - a, hi - a) if lo < hi else (0, 0)

    def shard_batch(self, batch):
        """This rank's rows of the global batch, over dp x sharding."""
        return shard_batch(tuple(batch), self.mesh, ("dp", self.axis))

    # -- a step ------------------------------------------------------------
    def begin_step(self):
        """Before the forward: at "os_g" the whole gradient span, the
        backward's accumulation target; the stage-3 counters reset."""
        self.peak_bytes = self.live_bytes
        self.seconds = {"gather": 0.0, "reduce_scatter": 0.0}
        if self.level == "os_g":
            for g in self.groups:
                if g.full_g is None:
                    g.full_g = torch.zeros_like(g.full_p)
                    g.units[0].grad_views(g.full_g)

    def _average(self, shard):
        """The sum over sharding, then over dp, divided by both."""
        if self.dp.nranks > 1:
            _coll._sum_noted(shard, self.dp, "all_reduce")
        return shard.div_(self.data_world)

    @torch.no_grad()
    def reduce_gradients(self):
        """Every rank's shard of the averaged gradient in its group's `g`.
        At "os" and "os_g" the whole gradient span is reduce-scattered
        (at "os_g" it is then dropped); at "p_g_os" the backward's hooks
        did it unit by unit, and what they left (a unit some of whose
        parameters got no gradient) is done here, in unit order."""
        if self.level == "p_g_os":
            for g in self.groups:
                for u in g.units:
                    if u.grad is not None or u.done:
                        self._unit_done(u)
            for s in self.scopes:
                if s.in_backward:
                    s.in_backward = False
                    s.done.clear()
                    self._release(s.all_units())
            return
        for g in self.groups:
            u = g.units[0]
            if g.full_g is None:
                g.full_g = torch.zeros_like(g.full_p)
            u.grad_views(g.full_g)
            if self.level == "os":
                shard = g.g.clone()
                _coll.reduce_scatter_flat(shard, g.full_g, self.group)
                g.g.copy_(self._average(shard))
            else:
                _coll.reduce_scatter_flat(g.g, g.full_g, self.group)
                self._average(g.g)
                for p in u.params:
                    p.grad = None
                g.full_g = None

    @torch.no_grad()
    def gather_parameters(self):
        """After the update ("os", "os_g"): every rank's updated chunk into
        every rank's parameter span, in place."""
        if self.level == "p_g_os":
            return
        for g in self.groups:
            _coll.all_gather_flat(g.full_p, g.p, self.group)

    def stats(self):
        """Stage 3's part of TrainStep.last_parts: the host seconds of the
        gathers and of the backward's reduce-scatters (inside fwd+bwd),
        and the peak of live gathered bytes since begin_step."""
        if self.level != "p_g_os":
            return {}
        return {"gathers_in_fwd_bwd_s": self.seconds["gather"],
                "reduce_scatter_in_bwd_s": self.seconds["reduce_scatter"],
                "gathered_peak_bytes": self.peak_bytes}

    @contextlib.contextmanager
    def gathered(self):
        """Every unit gathered for the block (stage 3; a collective): the
        whole parameters, to read or dump them. Nothing at "os" and
        "os_g", whose parameters are whole."""
        units = [] if self.level != "p_g_os" else \
            [u for g in self.groups for u in g.units]
        self._acquire(units)
        try:
            yield
        finally:
            self._release(units)

    # -- whole values of sharded entries -------------------------------------
    def gather(self, buf, p):
        """p's whole flattened values from the shard buffer `buf` (a
        collective over the sharding group): each rank sends its part,
        padded to the longest part. At "os" and "os_g" a parameter is
        whole on every rank already."""
        u, a, b = self.where[id(p)]
        if buf is u.group.p and self.level != "p_g_os":
            return p.detach().reshape(-1).clone()
        C, W, r = u.chunk, self.world, self.rank
        lens = [max(0, min(b, (q + 1) * C) - max(a, q * C))
                for q in range(W)]
        L = max(lens)
        mine = buf.new_zeros(L)
        at = u.local + max(a, r * C) - r * C
        mine[:lens[r]].copy_(buf[at:at + lens[r]])
        out = buf.new_empty(W * L)
        _coll.all_gather_flat(out, mine, self.group)
        return torch.cat([out[q * L:q * L + lens[q]] for q in range(W)])

    def assign(self, buf, p, value):
        """Keep this rank's part of p's whole `value` in `buf` (and the
        whole in p at "os" and "os_g" for the parameters)."""
        u, a, b = self.where[id(p)]
        flat = torch.as_tensor(value).reshape(-1).to(buf.device, buf.dtype)
        if flat.numel() != b - a:
            raise ValueError(f"a value of {flat.numel()} elements for a "
                             f"parameter of {b - a}")
        if buf is u.group.p and self.level != "p_g_os":
            p.detach().copy_(flat.view_as(p))
            return
        lo, hi = self.owned(p)
        if lo < hi:
            at = u.local + a + lo - self.rank * u.chunk
            buf[at:at + hi - lo].copy_(flat[lo:hi])

    def model_state(self, model):
        """model.state_dict() with each stage-3 parameter as a `_Sharded`
        entry (its storage is freed between uses)."""
        sd = model.state_dict()
        if self.level != "p_g_os":
            return dict(sd)
        params = dict(model.named_parameters())
        return {k: (_Sharded(self.where[id(params[k])][0].group, "p",
                             params[k])
                    if k in params and id(params[k]) in self.where else v)
                for k, v in sd.items()}

    # -- stage 3 -------------------------------------------------------------
    def _install(self):
        for s in self.scopes:
            s.enter.register_forward_pre_hook(
                lambda mod, args, s=s: self._acquire(s.all_units()))
            if s.enter is not s.exit:
                s.enter.register_forward_hook(
                    lambda mod, args, out, s=s: self._watch(s, out))
            s.exit.register_forward_hook(
                lambda mod, args, out, s=s: self._leave(s, out))
        for g in self.groups:
            for p in g.params:
                p.register_post_accumulate_grad_hook(self._grad_ready)

    def _acquire(self, units):
        for u in units:
            if u.refs == 0:
                t0 = time.perf_counter()
                u.buf.untyped_storage().resize_(
                    u.padded * u.buf.element_size())
                _coll.all_gather_flat(
                    u.buf, u.group.p[u.local:u.local + u.chunk], self.group)
                self.seconds["gather"] += time.perf_counter() - t0
                self.live_bytes += u.padded * u.buf.element_size()
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            u.refs += 1

    def _release(self, units):
        for u in units:
            u.refs -= 1
            if u.refs == 0:
                u.buf.untyped_storage().resize_(0)
                self.live_bytes -= u.padded * u.buf.element_size()

    def _watch(self, s, out):
        """Hooks on the tensors of `out` that gather `s`'s units before
        its backward (the first to fire, once a backward)."""
        def pre_backward(grad):
            if not s.in_backward:
                s.in_backward = True
                self._acquire(s.all_units())
            return grad

        stack = [out]
        while stack:
            x = stack.pop()
            if isinstance(x, (tuple, list)):
                stack.extend(x)
            elif torch.is_tensor(x) and x.requires_grad:
                x.register_hook(pre_backward)

    def _leave(self, s, out):
        self._watch(s, out)
        self._release(s.all_units())

    @torch.no_grad()
    def _grad_ready(self, p):
        u, a, b = self.where[id(p)]
        if u.grad is None:
            u.grad = torch.zeros(u.padded, dtype=p.dtype, device=p.device)
        view = u.grad[a:b].view_as(p)
        if p.grad.data_ptr() != view.data_ptr():    # a fresh gradient
            view.add_(p.grad)
            p.grad = view
        u.done.add(id(p))
        if len(u.done) == len(u.params):
            self._unit_done(u)

    def _unit_done(self, u):
        """Reduce-scatter the unit's gradient span into the shard, drop it,
        and release its scope once every unit the scope owns is done."""
        t0 = time.perf_counter()
        if u.grad is None:
            u.grad = torch.zeros(u.padded, dtype=u.buf.dtype,
                                 device=u.buf.device)
        part = u.grad.new_empty(u.chunk)
        _coll.reduce_scatter_flat(part, u.grad, self.group)
        u.group.g[u.local:u.local + u.chunk].add_(self._average(part))
        self.seconds["reduce_scatter"] += time.perf_counter() - t0
        for p in u.params:
            p.grad = None
        u.grad = None
        u.done.clear()
        s = u.scope
        s.done.add(id(u))
        if len(s.done) == len(s.units):
            s.done.clear()
            if s.in_backward:
                s.in_backward = False
                self._release(s.all_units())
