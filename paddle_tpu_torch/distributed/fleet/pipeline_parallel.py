"""Pipeline parallelism at the layer level (counterpart of paddle_tpu/
distributed/fleet/pipeline_parallel.py; reference: Paddle's PipelineParallel,
fleet/meta_parallel/pipeline_parallel.py:131, its PipeLayer segmentation,
parallel_layers/pp_layers.py).

`PipelineLayer` is the whole layer list and its segmentation into
num_stages (x V virtual) stages; a SharedLayerDesc at both ends with one
key builds ONE layer that runs before stage 0 and, through its
`forward_func`, as the head after the last (tied embedding and head).
`PipelineParallel` trains it over the pp group of the current mesh
(fleet.init at pp_degree > 1) with distributed/pipeline.py's engines,
one process a stage:

  * every rank builds every layer, as the reference does; this rank's
    stage (its V chunks g = v*S + r), the shared ends and the loss layer
    live on the rank's device, the other stages' layers stay on the host;
  * `parameters()` is this rank's chunks' parameters, then the shared and
    the loss parameters: build the optimizer over it. The stage
    parameters carry `_pp_group` (the group, True) and the shared and loss
    ones (the group, False), so a global-norm clip sums the stages'
    square-sums over the pp group and counts the tied ends once
    (nn/clip.py grad_square_sum);
  * `train_batch((inputs, labels), optimizer)` cuts the batch into
    `accumulate_steps` microbatches, runs the engine (tied ends or V > 1:
    the interleave engine, as in the reference) with the layers' own
    parameters swapped in by torch.func.functional_call, sets each
    parameter's gradient and steps the optimizer: every rank returns the
    whole loss;
  * `sync_layers_from_stacks` broadcasts each stage's parameters from its
    owner over the pp group into every rank's copy (a collective), so
    `state_dict()` and `forward` see the trained model, with the
    reference's keys, on every rank.

Beside dp and mp (fleet's hybrid configs; the reference runs its pipeline
in a shard_map over pp alone and lets GSPMD place dp and mp around it):

  * dp: `train_batch` takes this rank's rows of the global batch (what
    sharding_utils.shard_batch(batch, mesh, ("dp",)) returns, as each dp
    rank's loader gives them); after the engine, every gradient (the
    stage's, the tied ends' after the engine's pp sum, the loss
    parameters') is averaged over the rank's dp group by the bucketed
    reduce (grad_buckets.bucket_reduce), and the loss too: every rank
    returns the global mean;
  * mp: a stage's blocks are cut over the rank's mp group when the
    PipelineLayer builds them under the mesh (annotate_param); the
    engine's leaves keep the cut (distributed/pipeline.py), so the mp
    layers issue their collectives inside a stage's slots. Both mp ranks
    of a stage run the same ticks and compute nothing in a bubble, so
    every group's members issue their collectives in one order (gloo
    hangs otherwise). The scaler's found-inf flag is the maximum over the
    pp, mp and dp groups (the whole mesh), so every rank skips alike.

As in the reference, the stages must be structurally identical: one
stage function serves every chunk. pp beside a sep, sharding or ep axis
of more than one rank is refused (ROADMAP queue 1: pp beside sep,
sharding or ep). At pp = 1 `train_batch` is plain microbatched gradient
accumulation on the device.
"""
from __future__ import annotations

import time
from typing import List

import torch
from torch import nn

from ...nn.clip import ClipGradByGlobalNorm
from ...ops import nn_ops

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _device_of(layer):
    for t in layer.parameters():
        return t.device
    for t in layer.buffers():
        return t.device
    return None


def _on(layer, x):
    """`x` on `layer`'s device (a stage may live on another device than
    the next one's host copy)."""
    dev = _device_of(layer)
    return x if dev is None or not torch.is_tensor(x) else x.to(dev)


class PipelineLayer(nn.Module):
    """The full layer list plus its segmentation into `num_stages` stages
    (num_stages * V chunks with `num_virtual_pipeline_stages` V > 1).
    Uniform segmentation cuts the list into equal runs; seg_method
    "layer:<Class>" starts a stage at every k-th layer of that class."""

    def __init__(self, layers, num_stages=1, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=1, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages
        self._num_virtual = num_virtual_pipeline_stages
        self._recompute_interval = recompute_interval

        descs = list(layers)
        pre, post, shared_built = None, None, {}
        if descs and isinstance(descs[0], SharedLayerDesc):
            pre_desc = descs.pop(0)
            pre = pre_desc.build_layer()
            shared_built[pre_desc.layer_name] = pre
        self.shared_pre = pre            # the layer run before stage 0
        if descs and isinstance(descs[-1], SharedLayerDesc):
            post_desc = descs.pop(-1)
            layer = shared_built.get(post_desc.layer_name)
            if layer is None:
                layer = post_desc.build_layer()
                self.shared_post_layer = layer
            fwd = post_desc.forward_func
            if fwd is None:
                attr = post_desc.shared_weight_attr

                def fwd(lay, x, _attr=attr):
                    return nn_ops.matmul(x, getattr(lay, _attr),
                                         transpose_y=True)
            post = (layer, fwd)
        self.shared_post = post          # (layer, head function) or None

        built = [d.build_layer() if isinstance(d, LayerDesc) else d
                 for d in descs]
        self.run_function = nn.ModuleList(built)
        n_seg = num_stages * num_virtual_pipeline_stages
        self._num_segments = n_seg
        n = len(built)
        if seg_method.startswith("layer:"):
            cls_name = seg_method.split(":", 1)[1]
            marks = [i for i, lay in enumerate(built)
                     if type(lay).__name__ == cls_name]
            per = (len(marks) + n_seg - 1) // n_seg
            bounds = []
            for s in range(n_seg):
                lo = marks[s * per] if s * per < len(marks) else n
                hi = marks[(s + 1) * per] if (s + 1) * per < len(marks) \
                    else n
                bounds.append((lo if s else 0, hi))
            self._stage_bounds = bounds
        else:
            per = (n + n_seg - 1) // n_seg
            self._stage_bounds = [(i * per, min((i + 1) * per, n))
                                  for i in range(n_seg)]

    def forward(self, x):
        if self.shared_pre is not None:
            x = self.shared_pre(_on(self.shared_pre, x))
        for layer in self.run_function:
            x = layer(_on(layer, x))
        if self.shared_post is not None:
            layer, fwd = self.shared_post
            x = fwd(layer, _on(layer, x))
        return x

    def get_stage_layers(self, stage_id) -> List[nn.Module]:
        lo, hi = self._stage_bounds[stage_id]
        return list(self.run_function)[lo:hi]

    def shared_parameters(self) -> List[nn.Parameter]:
        seen, out = set(), []
        ends = [self.shared_pre] + \
            ([self.shared_post[0]] if self.shared_post is not None else [])
        for layer in ends:
            if layer is None:
                continue
            for p in layer.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    out.append(p)
        return out

    def stages_are_homogeneous(self) -> bool:
        """True when every stage has the same layer-class sequence and
        parameter shapes: one stage function then serves every chunk."""
        sigs = []
        for s in range(self._num_segments):
            sigs.append(tuple(
                (type(layer).__name__,
                 tuple((tuple(p.shape), str(p.dtype))
                       for p in layer.parameters()))
                for layer in self.get_stage_layers(s)))
        return all(sig == sigs[0] for sig in sigs)


class _Seq(nn.Module):
    """A chunk's layers run in order: the module functional_call swaps a
    chunk's parameters into."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Head(nn.Module):
    """The shared post layer and its head function, as one module."""

    def __init__(self, layer, fwd):
        super().__init__()
        self.layer = layer
        self._fwd = fwd

    def forward(self, y):
        return self._fwd(self.layer, y)


def _swapped(module, names, prefix=""):
    """fn(values, *args): `module` run with values[i] as its parameter
    names[i] (torch.func.functional_call)."""
    from torch.func import functional_call

    keys = [prefix + n for n in names]

    def fn(values, *args):
        return functional_call(module, dict(zip(keys, values)), args)
    return fn


# the axes pp does not run beside yet (dp and mp it does)
_REFUSED_AXES = ("sep", "sharding", "ep")


class PipelineParallel(nn.Module):
    """Trains a PipelineLayer over the pp group of the current mesh (see
    the module note). The strategy's pipeline_configs give
    accumulate_steps (M), schedule ("1F1B", "FThenB"; tied ends or V > 1
    make it "Interleave") and virtual_pp_degree (V, which must equal the
    layer's num_virtual_pipeline_stages). `device` defaults to the one
    init_parallel_env bound this rank to."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None,
                 device=None):
        super().__init__()
        from ..env import rank_device
        from ..mesh import get_mesh

        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                f"PipelineParallel wraps a PipelineLayer (the layer list "
                f"and its stages), got {type(layers).__name__}: build it "
                "from LayerDesc's, as GPT's and Llama's pipeline_descs do")
        self._layers = layers
        self._hcg = hcg
        pcfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = pcfg.get("accumulate_steps", 1)
        self.micro_batch_size = pcfg.get("micro_batch_size", 1)
        self.schedule = pcfg.get("schedule", "1F1B")
        if self.schedule not in ("1F1B", "FThenB", "Interleave"):
            raise ValueError(f"unknown pipeline schedule {self.schedule!r}")
        self._vpp = max(pcfg.get("virtual_pp_degree", layers._num_virtual),
                        1)
        if self._vpp != layers._num_virtual:
            raise ValueError(
                f"strategy virtual_pp_degree={self._vpp} does not match "
                f"PipelineLayer num_virtual_pipeline_stages="
                f"{layers._num_virtual}; a mismatch would silently drop "
                "stages from training")
        self._has_shared = (layers.shared_pre is not None
                            or layers.shared_post is not None)
        if self._vpp > 1 or self._has_shared:
            # virtual stages and tied ends take the interleave engine
            # (1F1B and F-then-B are its V = 1 special cases)
            self.schedule = "Interleave"
        self._device = torch.device(device) if device is not None \
            else rank_device()
        mesh = get_mesh()
        self._mesh = mesh
        pp = mesh.shape["pp"] if (mesh is not None
                                  and "pp" in mesh.axis_names) else 1
        self._pp_degree = pp
        self._stacks_dirty = True
        self.last_parts = None
        if pp <= 1:
            layers.to(self._device)
            return
        others = {a: mesh.shape[a] for a in _REFUSED_AXES
                  if mesh.shape.get(a, 1) > 1}
        if others:
            raise NotImplementedError(
                f"pipeline parallelism beside the {sorted(others)} axes "
                f"{others} is not ported (ROADMAP queue 1: pp beside sep, "
                "sharding or ep): pp runs alone or beside dp and mp")
        self._dp_group = mesh.group("dp") if mesh.shape["dp"] > 1 else None
        self._mp_group = mesh.group("mp") if mesh.shape["mp"] > 1 else None
        if layers._num_stages != pp:
            raise ValueError(
                f"PipelineLayer has {layers._num_stages} stages but the "
                f"mesh 'pp' axis has {pp} ranks")
        if not layers.stages_are_homogeneous():
            raise ValueError(
                "pipeline parallelism needs structurally identical stages "
                "(same layer classes and parameter shapes per stage); got "
                "heterogeneous stages. Express the embedding and head with "
                "SharedLayerDesc at the ends of the layer list and "
                "pipeline only the repeated blocks.")
        self._place(mesh.group("pp"))

    # ---- this rank's stage ------------------------------------------------
    def _segments(self):
        """The global stages this rank runs, chunk by chunk: g = v*S + r."""
        S, r = self._pp_degree, self._group.rank
        return [v * S + r for v in range(self._vpp)]

    def _place(self, group):
        self._group = group
        lay, dev = self._layers, self._device
        chunks = [lay.get_stage_layers(g) for g in self._segments()]
        for layer in [m for c in chunks for m in c]:
            layer.to(dev)
        for layer in (lay.shared_pre, lay.shared_post and
                      lay.shared_post[0]):
            if layer is not None:
                layer.to(dev)
        loss_fn = lay._loss_fn
        if isinstance(loss_fn, nn.Module):
            loss_fn.to(dev)
            self._loss_params = list(loss_fn.parameters())
        else:
            self._loss_params = []
        self._chunk_params = [[p for m in c for p in m.parameters()]
                              for c in chunks]
        self._shared_params = lay.shared_parameters()
        for ps in self._chunk_params:
            for p in ps:
                p._pp_group = (group, True)
        for p in self._shared_params + self._loss_params:
            p._pp_group = (group, False)
        # one stage function for every chunk (the stages are alike), as
        # the reference runs stage 0's layers with each chunk's values
        seq = _Seq(chunks[0])
        names = [n for n, _ in seq.named_parameters()]
        self._fns = {"stage": _swapped(seq, names)}
        index = {id(p): i for i, p in enumerate(self._shared_params)}
        if lay.shared_pre is not None:
            pn = list(lay.shared_pre.named_parameters())
            self._fns["pre"] = (_swapped(lay.shared_pre, [n for n, _ in pn]),
                                [index[id(p)] for _, p in pn])
        if lay.shared_post is not None:
            head = _Head(*lay.shared_post)
            pn = list(head.layer.named_parameters())
            self._fns["post"] = (
                _swapped(head, [n for n, _ in pn], prefix="layer."),
                [index[id(p)] for _, p in pn])
        if isinstance(loss_fn, nn.Module):
            names = [n for n, _ in loss_fn.named_parameters()]
            self._fns["loss"] = _swapped(loss_fn, names)
        elif loss_fn is not None:
            self._fns["loss"] = lambda lp, y, label: loss_fn(y, label)
        else:
            self._fns["loss"] = lambda lp, y, label: y.mean()

    def parameters(self, include_sublayers=True):
        if self._pp_degree > 1:
            return ([p for ps in self._chunk_params for p in ps]
                    + list(self._shared_params) + list(self._loss_params))
        return list(super().parameters(include_sublayers))

    def sync_layers_from_stacks(self):
        """Broadcast every stage's trained parameters from the rank that
        owns it (g % S) over the pp group into every rank's copy: a
        collective of the pp group. Skipped when no step ran since the
        last sync."""
        from ..collective import broadcast

        if self._pp_degree <= 1 or not self._stacks_dirty:
            return
        self._stacks_dirty = False
        S, g_pp = self._pp_degree, self._group
        with torch.no_grad():
            for g in range(self._layers._num_segments):
                owner = g_pp.ranks[g % S]
                mine = g % S == g_pp.rank
                for layer in self._layers.get_stage_layers(g):
                    for p in layer.parameters():
                        host = p.detach().cpu() if mine else p.data
                        broadcast(host, src=owner, group=g_pp)

    def state_dict(self, *args, **kwargs):
        self.sync_layers_from_stacks()
        return self._layers.state_dict(*args, **kwargs)

    def forward(self, *args, **kwargs):
        self.sync_layers_from_stacks()
        return self._layers(*args, **kwargs)

    # ---- the train_batch API ----------------------------------------------
    def _micro(self, t):
        t = torch.as_tensor(t).to(self._device)
        M = self.accumulate_steps
        if t.shape[0] % M:
            raise ValueError(f"batch {t.shape[0]} not divisible by "
                             f"accumulate_steps {M}")
        return t.reshape(M, t.shape[0] // M, *t.shape[1:])

    def _run_engine(self, xs, labels):
        """(loss, gradients in parameters() order) of one step."""
        from .. import pipeline as eng

        S, fns = self._pp_degree, self._fns
        if self.schedule == "Interleave":
            pre = post = None
            if "pre" in fns:
                f, idx = fns["pre"]
                pre = (lambda sh, x, f=f, idx=idx:
                       f([sh[i] for i in idx], x))
            if "post" in fns:
                f, idx = fns["post"]
                post = (lambda sh, y, f=f, idx=idx:
                        f([sh[i] for i in idx], y))
            loss, d_cs, d_sh, d_lp, _ = eng.run_interleave(
                fns["stage"], fns["loss"], self._group, S, self._vpp,
                self._chunk_params, self._loss_params, xs, labels, pre,
                post, self._shared_params, need_dxs=False)
            grads = [g for d in d_cs for g in d] + list(d_sh)
        else:
            run = eng.run_1f1b if self.schedule == "1F1B" \
                else eng.run_fthenb
            loss, d_p, d_lp, _ = run(
                fns["stage"], fns["loss"], self._group, S,
                self._chunk_params[0], self._loss_params, xs, labels,
                need_dxs=False)
            grads = list(d_p)
        return loss, grads + list(d_lp)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over `data` = (inputs, labels), the global
        batch (beside dp: this rank's rows of it), cut into
        accumulate_steps microbatches; returns the mean microbatch loss,
        over every dp rank's rows (the same on every rank). With an
        enabled `scaler` the gradients of the unscaled loss are multiplied
        by its scale, so scaler.step's unscale cancels and its skip still
        applies; the found-inf flag is the maximum over the pp, mp and dp
        groups, so every rank skips alike. `last_parts` holds the step's
        seconds: the engine's forward and backward slots, handoffs and end
        sum (pipeline.last_stats()), the gradients' hand-over, the dp
        reduce (`dp_reduce_s`, 0 without dp), the clip's square-sum and
        the update."""
        from .. import pipeline as eng
        from ..collective import ReduceOp, all_reduce

        inputs, labels = data
        if self._pp_degree <= 1:
            return self._train_batch_accumulate(inputs, labels, optimizer,
                                                lr_scheduler, scaler)
        sync = torch.cuda.synchronize if self._device.type == "cuda" \
            else (lambda: None)
        t0 = time.perf_counter()
        loss, grads = self._run_engine(self._micro(inputs),
                                       self._micro(labels))
        st = eng.last_stats()
        parts = {k: st[k] for k in ("fwd_s", "bwd_s", "handoff_s",
                                    "sum_s")}
        t1 = time.perf_counter()
        if self._dp_group is not None:
            # every gradient and the loss averaged over this stage's dp
            # replicas
            from ..grad_buckets import bucket_reduce

            grads = bucket_reduce(grads, self._dp_group)
            loss = all_reduce(loss.clone(), ReduceOp.SUM, self._dp_group) \
                / self._dp_group.nranks
            sync()
        t2 = time.perf_counter()
        parts["dp_reduce_s"] = t2 - t1
        scale = None
        if scaler is not None and scaler.is_enable():
            scaler._to(self._device)
            scale = scaler._scale
        with torch.no_grad():
            for p, g in zip(self.parameters(), grads):
                p.grad = g if scale is None else g.mul_(scale.to(g.dtype))
        del grads
        sync()
        t1, t2 = t2, time.perf_counter()
        parts["grads_s"] = t2 - t1
        if scaler is not None:
            if scaler.is_enable():
                scaler.unscale_(optimizer)
                for g in (self._group, self._mp_group, self._dp_group):
                    if g is not None:
                        all_reduce(scaler._found_inf_t, ReduceOp.MAX, g)
            scaler.step(optimizer)
        elif hasattr(optimizer, "_update") and \
                getattr(optimizer, "_zero", None) is None:
            # the square-sum apart, as TrainStep times it
            gsq = optimizer.grad_square_sum() if isinstance(
                optimizer._grad_clip, ClipGradByGlobalNorm) else None
            sync()
            t3 = time.perf_counter()
            parts["square_sum_s"] = t3 - t2
            optimizer._update(square_sum=gsq)
            t2 = t3
        else:
            optimizer.step()
        optimizer.clear_grad()
        sync()
        parts["apply_s"] = time.perf_counter() - t2
        if lr_scheduler is not None:
            lr_scheduler.step()
        self._stacks_dirty = True
        parts["wall_s"] = time.perf_counter() - t0
        self.last_parts = parts
        return loss

    def _train_batch_accumulate(self, inputs, labels, optimizer,
                                lr_scheduler, scaler):
        """pp = 1: plain microbatched gradient accumulation."""
        from ..pipeline import backward

        M = self.accumulate_steps
        xs, ys = self._micro(inputs), self._micro(labels)
        losses = []
        for x, y in zip(xs, ys):
            out = self._layers(x)
            lf = self._layers._loss_fn
            loss = (lf(out, y) if lf is not None else out) / M
            backward(scaler.scale(loss) if scaler is not None else loss,
                     None)
            losses.append(loss.detach())
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return torch.stack(losses).sum()
