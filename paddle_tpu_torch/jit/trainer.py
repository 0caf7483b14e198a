"""Training step (counterpart of paddle_tpu/jit/trainer.py TrainStep).

The reference compiles forward, backward and the optimizer update into one
XLA program. PyTorch runs eagerly, so the port's step is the same sequence
as separate launches: `loss_fn(*batch)`, `backward()`, the optimizer's
update (gradient clip included) and `optimizer.clear_grad()`, then the LR
scheduler's step. The reference's compiled step updates through the plain
`functional_update`, its eager AdamW through the fused kernel; the port's
step runs the fused kernel (the two formulas are algebraically the same),
one launch per parameter run.

`nan_guard=True` is the reference's step guard: one fp32 square-sum of the
gradients before clipping, `ok = isfinite(gsq) & isfinite(loss)`, and a
step that is not ok leaves parameters, masters, moments and beta powers
bitwise as they were. The reference selects between the updated and the
old state inside its program; the port hands the kernel a device skip
flag, so a skipped launch stores nothing and nothing waits on the host
before the update is queued. The beta powers are host floats, so the
update reads the flag once after queuing it (the reference reads its
`skipped` output once too) and advances them only on a clean step.

`telemetry=True` (default: FLAGS_metrics) emits one record a call through
observability.telemetry: step, loss, grad_norm (the same pre-clip
square-sum's root), lr, compute_s, skipped, samples, tokens and flops = 6
n_params tokens. Reading the loss and the norm to the host is the step's
sync, and it happens only with telemetry on. The reference's `autotune`
and `compile_cache` entries are left out: their modules are not ported. A
skipped step under metrics dumps the flight recorder (`on_nan_skip`).

Data parallelism (`dp_axis=`, the reference's explicit path, one process
a rank): the mesh is `mesh=` or the current one (`distributed.set_mesh(
distributed.build_mesh(dp=N))`, or `fleet.init`), and the step reduces
over this rank's group along `dp_axis`. A call takes the GLOBAL batch,
as the reference's does, and keeps this rank's rows (block `dp rank` of
`dp size` along each tensor's leading dimension), so one call runs in
both packages; a leading dimension that does not divide raises the
reference's error. The backward's post-accumulate hooks issue each
gradient bucket's all-reduce as soon as its members are ready
(`grad_bucket_mb`, default FLAGS_grad_bucket_mb; `dp_overlap` 'bucketed'
or 'fine', default FLAGS_dp_overlap; distributed/overlap.BucketTrigger);
what is still open drains after the backward. Then the loss is averaged
over the group, so the clip, the guard's square-sum and telemetry's
`grad_norm` all see the global gradients (pmean semantics), every rank
alike: a NaN on one rank skips the step on all of them. The port's AdamW
gets its gradient views at construction, so a bucket of neighbours is
one slice of its flat buffer, reduced in place. Every rank must build
the same step and call it for the same steps, telemetry included.
Telemetry adds `reduce_s`: as the reference measures it, a comm-only
probe (`overlap.reduce_flush` of the cleared, zero gradients, in place,
no memory of its own) timed every `_REDUCE_PROBE_EVERY` steps and carved
out of compute. With telemetry on, the step also synchronises the device
after the backward and after the reduction and keeps `last_parts`: the
seconds of fwd+bwd (with the hooks' reduces in flight), of the wait for
the last bucket (and the loss's average), and of the update.

Without the guard and telemetry the step has no host sync inside; the
caller decides when to read the loss.

`forward_backward(*batch)` is the step without its update (the
reference's `_fwd_bwd_fn`, collective-free on every path), for a caller
that exchanges the gradients before applying them
(resilience.ElasticTrainer): the loss, under the amp
state `loss_fn` sets, and every trainable parameter's gradient, a zero one
where the loss did not reach it, as the reference's returns; with AdamW
the gradients are its flat buffer's views. `invalidate_executables()` is
the reference's hook for a changed world size: the port runs eagerly and
compiles nothing, so it drops what the step cached from the batches it
saw (the samples and tokens a telemetry record counts), the bucket plan
and the reduce probe's reading.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.flags import get_flag
from ..core.place import resolve_device
from ..observability import flight_recorder as _flight
from ..observability import telemetry as _telemetry
from ..observability.spans import span as _span


class TrainStep:
    """Usage:
        step = TrainStep(model, loss_fn, optimizer)   # loss_fn(*batch)->loss
        loss = step(x, y)

    `device=None` is the current CUDA device (raising when there is none);
    the model's parameters must lie on the resolved device, and batch
    entries (tensors or numpy arrays) are moved there. `mesh`, `dp_axis`,
    `grad_bucket_mb` and `dp_overlap` are the reference's data-parallel
    arguments (see the module note); `in_shardings` and `out_shardings`
    are accepted only to refuse them as the reference does beside
    `dp_axis` (GSPMD placements are not ported)."""

    _REDUCE_PROBE_EVERY = 50  # steps between reduce-probe measurements

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, device=None, nan_guard: bool = False,
                 telemetry: Optional[bool] = None, *, mesh=None,
                 dp_axis: Optional[str] = None,
                 grad_bucket_mb: Optional[int] = None,
                 dp_overlap: Optional[str] = None, in_shardings=None,
                 out_shardings=None):
        if dp_overlap is not None:
            dp_overlap = str(dp_overlap).lower()
            if dp_overlap not in ("bucketed", "fine"):
                raise ValueError(
                    f"dp_overlap={dp_overlap!r}: expected 'bucketed' or "
                    "'fine'")
        self._dp_axis = dp_axis
        self._dp_overlap = dp_overlap
        self._bucket_bytes = None if grad_bucket_mb is None else (
            int(grad_bucket_mb) << 20 if grad_bucket_mb >= 0 else 1 << 62)
        self._dp_group = None
        if dp_axis is not None:
            from ..distributed.mesh import get_mesh

            dp_mesh = mesh if mesh is not None else get_mesh()
            if dp_mesh is None:
                raise ValueError(
                    f"dp_axis={dp_axis!r} needs an active mesh but none is "
                    "set — pass mesh= or call distributed.set_mesh(...) "
                    "(distributed.build_mesh(dp=N) makes one)")
            if dp_axis not in dp_mesh.axis_names:
                sizes = dict(dp_mesh.shape)
                raise ValueError(
                    f"dp_axis={dp_axis!r} is not an axis of the active "
                    f"mesh — available axes and sizes: {sizes}")
            if in_shardings is not None or out_shardings is not None:
                raise ValueError(
                    "dp_axis= replaces in_shardings/out_shardings: the "
                    "shard_map specs define the placement")
            self._dp_group = dp_mesh.group(dp_axis)
        elif in_shardings is not None or out_shardings is not None:
            raise NotImplementedError(
                "TrainStep in_shardings/out_shardings: GSPMD placements are "
                "not ported (ROADMAP queue 1, item 3: sharding.py)")
        self.device = resolve_device(device)
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"TrainStep on {self.device}: parameter "
                                 f"{name} is on {p.device}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._nan_guard = bool(nan_guard)
        # resolved at construction, as the reference's (it changes that
        # program's outputs)
        self._telemetry = (_telemetry.enabled() if telemetry is None
                           else bool(telemetry))
        self.skipped_steps = 0
        self.last_skipped = False
        self._step_i = 0
        self._n_params = None
        self._batch_dims = None
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._trigger = None          # (flags, the bucket plan)
        self._reduce_s = None
        self._probe_step = -(1 << 30)
        self.last_parts = None
        if self._dp_world > 1:
            views = getattr(optimizer, "_grad_views", None)
            if views is not None:     # AdamW: buckets slice its buffers
                views()

    @property
    def _dp_world(self) -> int:
        g = self._dp_group
        return 1 if g is None or g.rank < 0 else int(g.nranks)

    def _overlap_mode(self) -> str:
        """The constructor's dp_overlap, else FLAGS_dp_overlap (read at
        every call, as the reference reads it at every trace)."""
        mode = self._dp_overlap if self._dp_overlap is not None else \
            str(get_flag("dp_overlap")).lower()
        if mode not in ("bucketed", "fine"):
            raise ValueError(
                f"FLAGS_dp_overlap={mode!r}: expected 'bucketed' or 'fine'")
        return mode

    def _bucket_trigger(self):
        """The bucket plan for the current flags, rebuilt when a flag it
        closes over changed (the reference re-traces then)."""
        from ..distributed import overlap as _overlap
        from ..distributed.grad_buckets import default_bucket_bytes

        cfg = (self._overlap_mode(),
               self._bucket_bytes if self._bucket_bytes is not None
               else default_bucket_bytes(), _overlap.min_ring_bytes())
        if self._trigger is None or self._trigger[0] != cfg:
            self._trigger = (cfg, _overlap.BucketTrigger(
                self._params, self._dp_group, cfg[1], cfg[0]))
            self._reduce_s = None
            self._probe_step = -(1 << 30)
        return self._trigger[1]

    def _shard_batch(self, batch):
        """This rank's rows of the global batch: block `dp rank` of `dp
        size` along each tensor's leading dimension."""
        n, r = int(self._dp_group.nranks), max(self._dp_group.rank, 0)
        out = []
        for x in batch:
            shape = tuple(getattr(x, "shape", ()))
            if (torch.is_tensor(x) or isinstance(x, np.ndarray)) and shape:
                if shape[0] % n != 0:
                    raise ValueError(
                        f"dp_axis={self._dp_axis!r} (size {n}) cannot split "
                        f"a batch leaf of shape {shape}: leading dim "
                        f"{shape[0]} is not divisible by {n}")
                m = shape[0] // n
                x = x[r * m:(r + 1) * m]
            out.append(x)
        return tuple(out)

    def _place(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if torch.is_tensor(x):
            return x.to(self.device, non_blocking=True)
        return x

    def __call__(self, *batch):
        opt = self.optimizer
        lr = float(np.float32(opt.get_lr()))    # the fp32 lr the update takes
        self._step_i += 1
        t0 = time.perf_counter() if self._telemetry else 0.0
        marks = [] if self._telemetry and self._dp_world > 1 else None
        with _span("jit.train_step", cat="jit"):
            if self._dp_group is not None:
                batch = self._shard_batch(batch)
            batch = tuple(self._place(x) for x in batch)
            if self._dp_world > 1:
                loss = self._dp_fwd_bwd(batch, marks)
            else:
                loss = self._fwd_bwd(batch)
            gsq = skip = None
            if self._nan_guard or self._telemetry:
                gsq = opt.grad_square_sum()
            if self._nan_guard:
                ok = torch.isfinite(gsq) & torch.isfinite(loss.float())
                skip = (~ok).to(torch.int32)
            skipped = opt._update(skip=skip, square_sum=gsq)
            opt.clear_grad()
        if self._nan_guard:
            self.last_skipped = bool(skipped)
            self.skipped_steps += int(skipped)
        sched = opt._lr_scheduler
        if sched is not None:
            sched.step()
        if self._telemetry:
            self._emit_step(loss, gsq, lr, t0, batch, marks)
        return loss

    def _fwd_bwd(self, batch):
        loss = self.loss_fn(*batch)
        loss.backward()
        return loss.detach()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dp_fwd_bwd(self, batch, marks):
        """The forward and backward with every gradient bucket's reduction
        issued from the hooks and drained, then the loss averaged over the
        group. `marks` (a list, with telemetry) collects the host times
        after the backward and after the reduction, each after a device
        sync."""
        from ..distributed.collective import ReduceOp, all_reduce

        trigger = self._bucket_trigger()
        loss = self.loss_fn(*batch)

        def backward():
            loss.backward()
            if marks is not None:
                self._sync()
                marks.append(time.perf_counter())

        trigger.run(backward)
        loss = all_reduce(loss.detach().clone(), ReduceOp.SUM,
                          self._dp_group).div_(self._dp_world)
        if marks is not None:
            self._sync()
            marks.append(time.perf_counter())
        return loss

    def forward_backward(self, *batch):
        """(loss, grads): the forward and backward of one step, nothing
        applied (see the module note)."""
        loss = self._fwd_bwd(tuple(self._place(x) for x in batch))
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        prepare = getattr(self.optimizer, "_prepare", None)
        if prepare is not None:        # AdamW: adopt into its flat buffers
            prepare()
        return loss, [p.grad for p in params]

    def invalidate_executables(self) -> None:
        """Forget what was cached from earlier batches (their samples and
        tokens; the parameter count): a reformed world feeds other shard
        sizes. Nothing is compiled, so nothing else is dropped."""
        self._n_params = None
        self._batch_dims = None
        self._trigger = None
        self._reduce_s = None
        self._probe_step = -(1 << 30)

    def _probe_reduce_s(self) -> Optional[float]:
        """The reference's attributed reduce time: the data-parallel
        reduction alone (overlap.reduce_flush with this step's buckets and
        schedule) over the gradients, which the update's clear_grad left
        zero, timed every `_REDUCE_PROBE_EVERY` steps from a device sync
        to a device sync. The step's own reduction has warmed the group
        and the host buffers, so no warm call precedes it. Every rank
        probes at the same steps (it is collective)."""
        if self._dp_world <= 1:
            return None
        if self._step_i - self._probe_step < self._REDUCE_PROBE_EVERY:
            return self._reduce_s
        from ..distributed import overlap as _overlap

        cfg = self._trigger[0]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        self._sync()
        t0 = time.perf_counter()
        _overlap.reduce_flush(grads, self._dp_group, cfg[1], mode=cfg[0])
        self._sync()
        self._reduce_s = time.perf_counter() - t0
        self._probe_step = self._step_i
        return self._reduce_s

    def _emit_step(self, loss, gsq, lr, t0, batch, marks=None):
        """Build and stage this step's record. Reading the loss and the norm
        is the step's sync, so compute_s measured after it covers the
        device's work."""
        loss_f = float(loss)
        gnorm_f = float(gsq.sqrt())
        t_end = time.perf_counter()
        compute_s = t_end - t0
        if marks:
            self.last_parts = {"fwd_bwd_s": marks[0] - t0,
                               "reduce_wait_s": marks[1] - marks[0],
                               "apply_s": t_end - marks[1]}
        if self._n_params is None:
            self._n_params = sum(p.numel() for p in self.model.parameters()
                                 if p.requires_grad)
        if self._batch_dims is None:
            # samples: the first tensor's leading dim; tokens: the first
            # integer tensor of rank >= 2, its first two dims
            samples = tokens = None
            for x in batch:
                if not torch.is_tensor(x) or x.dim() == 0:
                    continue
                if samples is None:
                    samples = int(x.shape[0])
                if tokens is None and x.dim() >= 2 and \
                        not x.is_floating_point():
                    tokens = int(x.shape[0]) * int(x.shape[1])
            self._batch_dims = (samples, tokens)
        samples, tokens = self._batch_dims
        core = {"step": self._step_i - 1, "loss": loss_f,
                "grad_norm": gnorm_f, "lr": lr, "compute_s": compute_s,
                "skipped": self.last_skipped if self._nan_guard else False}
        reduce_s = self._probe_reduce_s()
        if reduce_s:
            core["reduce_s"] = round(min(reduce_s, compute_s), 6)
        if samples:
            core["samples"] = samples
        if tokens:
            core["tokens"] = tokens
            core["flops"] = 6.0 * self._n_params * tokens
        _telemetry.get_telemetry().on_step(core)
        if self._nan_guard and self.last_skipped:
            _flight.on_nan_skip(self._step_i - 1, loss=loss_f)
