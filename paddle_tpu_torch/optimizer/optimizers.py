"""AdamW (counterpart of paddle_tpu/optimizer/optimizers.py Adam:51 /
AdamW:129).

`step()` updates every parameter group (same dtype and device, weight decay
on or off) with ONE launch of the fused AdamW kernel
(ops/gpu/fused_adamw.py), as the reference's eager AdamW.step does
(optimizers.py:163-236). It does not concatenate anything per step: on the
first step each group's parameters, gradients and moments become views of
four flat float32 buffers (as DDP's gradient_as_bucket_view does for
gradients), so backward accumulates straight into the flat gradient buffer
and the kernel walks the group in one pass. Parameters whose beta powers
differ (one skipped a step) or that have no gradient split the group into
runs of one launch each, as the reference's grouping key does.

After `clear_grad()` (set_to_zero=True) the gradients stay zeroed views, so
a parameter that has taken part in a step is updated on every later step,
with a zero gradient if the loss did not reach it, as in the reference's
compiled TrainStep; `clear_grad(set_to_zero=False)` drops them, as its eager
clear_grad does, and the next step copies them in again.

With FLAGS_use_fused_adamw off, each parameter takes the reference's plain
per-parameter rule (`_adam_step`, optimizers.py:79-91) instead.
"""
from __future__ import annotations

import torch

from ..core.flags import get_flag
from ..nn.clip import ClipGradByGlobalNorm
from ..ops.gpu.fused_adamw import f32, fused_adamw
from .optimizer import Optimizer


class _FlatGroup:
    """One (dtype, device, wd_on) group: parameters, gradients and both
    moments as views of four flat buffers, in parameter-list order."""

    def __init__(self, params, states, wd_on):
        p0 = params[0]
        if p0.dtype != torch.float32:
            raise NotImplementedError(
                f"AdamW over {p0.dtype} parameters needs fp32 master "
                "weights (ROADMAP item 'amp O2')")
        self.params, self.wd_on = params, wd_on
        self.bounds = []
        off = 0
        for p in params:
            self.bounds.append((off, off + p.numel()))
            off += p.numel()
        kw = dict(dtype=torch.float32, device=p0.device)
        self.p = torch.empty(off, **kw)
        self.g = torch.zeros(off, **kw)
        self.m = torch.zeros(off, **kw)
        self.v = torch.zeros(off, **kw)
        self.grads = []
        with torch.no_grad():
            for p, st, (a, b) in zip(params, states, self.bounds):
                self.p[a:b].copy_(p.detach().reshape(-1))
                p.data = self.p[a:b].view_as(p)
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
            _FlatGroup(ps, [self._state[id(p)] for p in ps], key[2])
            for key, ps in keyed.items()]

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

    @torch.no_grad()
    def step(self):
        if self._groups is None:
            self._build_groups()
        for group in self._groups:
            group.adopt_grads()
        runs = [(group, run) for group in self._groups
                for run in self._runs(group)]
        scale = 1.0
        clip = self._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            if runs:
                scale = clip.scale([g.g[a:b] for g, (a, b, *_) in runs])
        elif clip is not None:
            pairs = clip([(p, p.grad) for _, run in runs for p in run[4]])
            for p, g in pairs:
                p.grad.copy_(g)
        lr = self.get_lr()
        b1, b2 = f32(self._beta1), f32(self._beta2)
        fused = get_flag("use_fused_adamw")
        for group, (a, b, b1p, b2p, params) in runs:
            wd = self._decoupled_wd * group.wd_on
            if fused:
                fused_adamw(group.p[a:b], group.g[a:b], group.m[a:b],
                            group.v[a:b], lr=lr, beta1=self._beta1,
                            beta2=self._beta2, eps=self._eps,
                            weight_decay=wd,
                            bias_correction1=1.0 - f32(b1p * b1),
                            bias_correction2=1.0 - f32(b2p * b2),
                            grad_scale=scale)
            else:
                for p in params:
                    self._adam_step(p, scale, lr, wd)
            for p in params:
                st = self._state[id(p)]
                st["beta1_pow"] = f32(st["beta1_pow"] * b1)
                st["beta2_pow"] = f32(st["beta2_pow"] * b2)
        self._step_count += 1

    def _adam_step(self, p, scale, lr, wd):
        """The reference's per-parameter rule, in place (plain torch)."""
        st = self._state[id(p)]
        b1, b2 = f32(self._beta1), f32(self._beta2)
        b1p, b2p = f32(st["beta1_pow"] * b1), f32(st["beta2_pow"] * b2)
        g = p.grad.float() * scale
        m, v = st["moment1"], st["moment2"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        p.mul_(1.0 - lr * wd)
        p.sub_(lr * m_hat / (v_hat.sqrt() + self._eps))

    def clear_grad(self, set_to_zero=True):
        if set_to_zero and self._groups is not None:
            for group in self._groups:
                group.g.zero_()
            return
        super().clear_grad(set_to_zero)
