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
sync, and it happens only with telemetry on. The reference's `autotune`,
`compile_cache` and `reduce_s` entries are left out: their modules are not
ported and there is no data parallelism yet. A skipped step under metrics
dumps the flight recorder (`on_nan_skip`).

Without the guard and telemetry the step has no host sync inside; the
caller decides when to read the loss.

`forward_backward(*batch)` is the step without its update (the
reference's `_fwd_bwd_fn`), for a caller that exchanges the gradients
before applying them (resilience.ElasticTrainer): the loss, under the amp
state `loss_fn` sets, and every trainable parameter's gradient, a zero one
where the loss did not reach it, as the reference's returns; with AdamW
the gradients are its flat buffer's views. `invalidate_executables()` is
the reference's hook for a changed world size: the port runs eagerly and
compiles nothing, so it drops what the step cached from the batches it
saw (the samples and tokens a telemetry record counts).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

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
    entries (tensors or numpy arrays) are moved there."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, device=None, nan_guard: bool = False,
                 telemetry: Optional[bool] = None):
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
        with _span("jit.train_step", cat="jit"):
            batch = tuple(self._place(x) for x in batch)
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
            self._emit_step(loss, gsq, lr, t0, batch)
        return loss

    def _fwd_bwd(self, batch):
        loss = self.loss_fn(*batch)
        loss.backward()
        return loss.detach()

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

    def _emit_step(self, loss, gsq, lr, t0, batch):
        """Build and stage this step's record. Reading the loss and the norm
        is the step's sync, so compute_s measured after it covers the
        device's work."""
        loss_f = float(loss)
        gnorm_f = float(gsq.sqrt())
        compute_s = time.perf_counter() - t0
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
        if samples:
            core["samples"] = samples
        if tokens:
            core["tokens"] = tokens
            core["flops"] = 6.0 * self._n_params * tokens
        _telemetry.get_telemetry().on_step(core)
        if self._nan_guard and self.last_skipped:
            _flight.on_nan_skip(self._step_i - 1, loss=loss_f)
