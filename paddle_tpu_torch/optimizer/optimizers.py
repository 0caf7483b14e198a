"""AdamW (counterpart of paddle_tpu/optimizer/optimizers.py Adam:51 /
AdamW:129).

`step()` updates every parameter group (same dtype and device, weight decay
on or off) with ONE launch of the fused AdamW kernel
(ops/gpu/fused_adamw.py), as the reference's eager AdamW.step does
(optimizers.py:163-236). It does not concatenate anything per step: on the
first step each group's parameters, gradients and moments become views of
flat buffers (as DDP's gradient_as_bucket_view does for gradients), so
backward accumulates straight into the flat gradient buffer and the kernel
walks the group in one pass. Parameters whose beta powers differ (one
skipped a step) or that have no gradient split the group into runs of one
launch each, as the reference's grouping key does.

fp32 groups hold four fp32 buffers (parameters, gradients, m, v) and take
the kernel's fp32 form. Under `multi_precision` (amp O2's `decorate`) a
bf16 or fp16 group holds five: the parameters and their gradients in the
group's dtype, the fp32 master (`state["master"]`, the reference's
`_get_state` master) and m and v; it takes the kernel's master form, which
updates the master and writes the parameters' copy of it in the same pass.
The reference's eager AdamW leaves multi-precision groups to its base
class's per-parameter rule (optimizers.py:174-178); its compiled TrainStep
updates them through `functional_update` via the master, which is the
formula this form computes. A global-norm clip's factor is folded into the
launch as a device scalar; a clipped low-precision gradient is rounded to
its dtype first, as the reference's `functional_clip` returns it.

After `clear_grad()` (set_to_zero=True) the gradients stay zeroed views, so
a parameter that has taken part in a step is updated on every later step,
with a zero gradient if the loss did not reach it, as in the reference's
compiled TrainStep; `clear_grad(set_to_zero=False)` drops them, as its eager
clear_grad does, and the next step copies them in again.

With FLAGS_use_fused_adamw off, each parameter takes the reference's plain
per-parameter rule (`_adam_step`, optimizers.py:79-91, through the master
where there is one) instead.
"""
from __future__ import annotations

import torch

from ..core.flags import get_flag
from ..nn.clip import ClipGradByGlobalNorm, grad_square_sum
from ..ops.gpu.fused_adamw import f32, fused_adamw, fused_adamw_master
from .optimizer import Optimizer

_LOW = (torch.bfloat16, torch.float16)


class _FlatGroup:
    """One (dtype, device, wd_on) group: parameters, gradients, moments and,
    in the master form, the fp32 masters as views of flat buffers, in
    parameter-list order."""

    def __init__(self, params, states, wd_on, multi_precision):
        p0 = params[0]
        has_master = multi_precision and p0.dtype in _LOW
        if p0.dtype != torch.float32 and not has_master:
            raise NotImplementedError(
                f"AdamW over {p0.dtype} parameters keeps fp32 master "
                "weights: pass multi_precision=True, or "
                "amp.decorate(model, optimizer, level='O2')")
        self.params, self.wd_on = params, wd_on
        self.bounds = []
        off = 0
        for p in params:
            self.bounds.append((off, off + p.numel()))
            off += p.numel()
        f32kw = dict(dtype=torch.float32, device=p0.device)
        self.p = torch.empty(off, dtype=p0.dtype, device=p0.device)
        self.g = torch.zeros(off, dtype=p0.dtype, device=p0.device)
        self.master = torch.empty(off, **f32kw) if has_master else None
        self.m = torch.zeros(off, **f32kw)
        self.v = torch.zeros(off, **f32kw)
        self.grads = []
        with torch.no_grad():
            for p, st, (a, b) in zip(params, states, self.bounds):
                self.p[a:b].copy_(p.detach().reshape(-1))
                p.data = self.p[a:b].view_as(p)
                if has_master:
                    self.master[a:b].copy_(self.p[a:b])
                    st["master"] = self.master[a:b].view_as(p)
                st["moment1"] = self.m[a:b].view_as(p)
                st["moment2"] = self.v[a:b].view_as(p)
                self.grads.append(self.g[a:b].view_as(p))

    def adopt_grads(self):
        """Make every present gradient the flat buffer's view (a copy the
        first time, or after clear_grad(set_to_zero=False))."""
        for p, view in zip(self.params, self.grads):
            if p.grad is not None and p.grad is not view:
                view.copy_(p.grad)
                p.grad = view


class AdamW(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        if lr_ratio is not None or lazy_mode:
            raise NotImplementedError("AdamW lr_ratio / lazy_mode are not "
                                      "ported")
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._decoupled_wd = (float(weight_decay)
                              if isinstance(weight_decay, (int, float))
                              else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._groups = None

    def _init_state(self, p):
        wd_on = 1.0
        if self._apply_decay_param_fun is not None:
            wd_on = 1.0 if self._apply_decay_param_fun(
                self._names.get(id(p), "")) else 0.0
        return {"moment1": None, "moment2": None, "beta1_pow": 1.0,
                "beta2_pow": 1.0, "wd_on": wd_on}

    def _build_groups(self):
        keyed = {}
        for p in self._parameter_list:
            if p.requires_grad:
                st = self._get_state(p)
                keyed.setdefault((p.dtype, p.device, st["wd_on"]),
                                 []).append(p)
        self._groups = [
            _FlatGroup(ps, [self._state[id(p)] for p in ps], key[2],
                       self._multi_precision)
            for key, ps in keyed.items()]

    def _materialize_state(self):
        if self._groups is None:
            self._build_groups()

    @torch.no_grad()
    def _grad_views(self):
        """Give every parameter its flat buffer's gradient view now (zeros
        where it had no gradient), so the next backward accumulates in
        place and a data-parallel bucket of neighbours is one slice of
        the buffer (distributed/grad_buckets.py)."""
        self._materialize_state()
        for group in self._groups:
            group.adopt_grads()
            for p, view in zip(group.params, group.grads):
                if p.grad is None:
                    p.grad = view

    def _runs(self, group):
        """Maximal runs [(start, end, beta1_pow, beta2_pow, params)] of
        neighbouring parameters that have gradients and share beta powers."""
        runs = []
        for p, (a, b) in zip(group.params, group.bounds):
            if p.grad is None:
                continue
            st = self._state[id(p)]
            pows = (st["beta1_pow"], st["beta2_pow"])
            if runs and runs[-1][1] == a and tuple(runs[-1][2:4]) == pows:
                runs[-1][1] = b
                runs[-1][4].append(p)
            else:
                runs.append([a, b, *pows, [p]])
        return runs

    def _prepare(self):
        """[(group, run)] of this step, the gradients adopted into the flat
        buffers (the groups are built at the first call)."""
        self._materialize_state()
        for group in self._groups:
            group.adopt_grads()
        return [(group, run) for group in self._groups
                for run in self._runs(group)]

    @staticmethod
    def _square_sum(runs):
        return grad_square_sum([g.g[a:b] for g, (a, b, *_) in runs])

    @torch.no_grad()
    def grad_square_sum(self):
        """The fp32 square-sum of every present gradient, before any clip,
        as a 0-d tensor on the parameters' device (no host sync)."""
        runs = self._prepare()
        if not runs:
            return torch.zeros((), dtype=torch.float32,
                               device=self._parameter_list[0].device)
        return self._square_sum(runs)

    def step(self):
        self._update()

    @torch.no_grad()
    def _update(self, skip=None, square_sum=None):
        """One step; returns whether it was skipped. `skip`, a 0-d int32
        device tensor (TrainStep's NaN guard), makes the kernel store
        nothing when nonzero; it is read on the host once, after every
        launch is queued, because the beta powers are host floats that
        advance only on a step that ran. `square_sum`, the gradients'
        pre-clip square-sum when the caller has it, spares the global-norm
        clip its own reduction."""
        runs = self._prepare()
        scale = 1.0
        clip = self._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            if runs:
                if square_sum is None:
                    square_sum = self._square_sum(runs)
                scale = clip.factor(square_sum)
        elif clip is not None:
            pairs = clip([(p, p.grad) for _, run in runs for p in run[4]])
            for p, g in pairs:
                p.grad.copy_(g)
        lr = self.get_lr()
        b1, b2 = f32(self._beta1), f32(self._beta2)
        fused = get_flag("use_fused_adamw")
        # the plain rule reads the flag first: it has no device-side skip
        skipped = not fused and skip is not None and bool(skip)
        for group, (a, b, b1p, b2p, params) in ([] if skipped else runs):
            wd = self._decoupled_wd * group.wd_on
            if not fused:
                for p in params:
                    self._adam_step(p, scale, lr, wd)
                continue
            kw = dict(lr=lr, beta1=self._beta1, beta2=self._beta2,
                      eps=self._eps, weight_decay=wd,
                      bias_correction1=1.0 - f32(b1p * b1),
                      bias_correction2=1.0 - f32(b2p * b2),
                      grad_scale=scale, skip=skip)
            if group.master is not None:
                fused_adamw_master(group.master[a:b], group.g[a:b],
                                   group.m[a:b], group.v[a:b],
                                   group.p[a:b], **kw)
            else:
                fused_adamw(group.p[a:b], group.g[a:b], group.m[a:b],
                            group.v[a:b], **kw)
        if fused and skip is not None:
            skipped = bool(skip)
        if not skipped:
            for _, run in runs:
                for p in run[4]:
                    st = self._state[id(p)]
                    st["beta1_pow"] = f32(st["beta1_pow"] * b1)
                    st["beta2_pow"] = f32(st["beta2_pow"] * b2)
        self._step_count += 1
        return skipped

    def _adam_step(self, p, scale, lr, wd):
        """The reference's per-parameter rule, in place (plain torch),
        through the fp32 master where there is one."""
        st = self._state[id(p)]
        b1, b2 = f32(self._beta1), f32(self._beta2)
        b1p, b2p = f32(st["beta1_pow"] * b1), f32(st["beta2_pow"] * b2)
        g = p.grad.float() * scale
        if p.grad.dtype != torch.float32:
            g = g.to(p.grad.dtype).float()
        m, v = st["moment1"], st["moment2"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        w = st.get("master", p)
        w.mul_(1.0 - lr * wd)
        w.sub_(lr * m_hat / (v_hat.sqrt() + self._eps))
        if w is not p:
            p.copy_(w)

    def clear_grad(self, set_to_zero=True):
        if set_to_zero and self._groups is not None:
            for group in self._groups:
                group.g.zero_()
            return
        super().clear_grad(set_to_zero)
