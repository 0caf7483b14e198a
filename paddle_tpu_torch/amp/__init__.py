"""AMP: `auto_cast`, `decorate`, `GradScaler` and `LossScaleBackoff`
(counterpart of paddle_tpu/amp/__init__.py).

O1: the ops on the white list run in the low-precision dtype (bfloat16 by
default), those on the black list in float32, parameters stay float32.
O2: `decorate` casts the floating parameters to that dtype in place and
sets the optimizers' `_multi_precision`, so AdamW keeps fp32 master
weights; `auto_cast(level="O2")` casts as O1 does (amp/state.py says why).

`GradScaler` is the reference's dynamic loss scaling: its scale, good and
bad counts and found-inf flag are 0-d device tensors, unscaling and the
finite check run on the device into one found-inf scalar, the schedule is
updated on the device, and `step()` reads that scalar once on the host to
decide whether the optimizer steps. The reference all-reduces found-inf
over the world group; the port has no data parallelism yet, so there is
no group to reduce over.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.dtype import convert_dtype
from .state import BLACK_LIST, WHITE_LIST, amp_state, cast_inputs

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "LossScaleBackoff", "is_float16_supported",
           "is_bfloat16_supported", "amp_state", "cast_inputs",
           "WHITE_LIST", "BLACK_LIST"]

_LEVELS = ("O0", "O1", "O2")


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    if level not in _LEVELS:
        raise ValueError(f"auto_cast level {level!r}: expected one of "
                         f"{_LEVELS}")
    st = amp_state()
    prev = (st.enabled, st.dtype, st.level, st.custom_white, st.custom_black)
    st.enabled = bool(enable)
    st.dtype = convert_dtype(dtype)
    st.level = level
    st.custom_white = frozenset(custom_white_list or ())
    st.custom_black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.dtype, st.level, st.custom_white,
         st.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """O2: cast every floating parameter of `models` to `dtype` in place
    (the parameter objects stay, so optimizers built over them still hold
    them) and give `optimizers` fp32 master weights unless `master_weight`
    is False. Returns models, or (models, optimizers)."""
    dt = convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        opt_list = ([] if optimizers is None else optimizers
                    if isinstance(optimizers, (list, tuple))
                    else [optimizers])
        for o in opt_list:
            if getattr(o, "_groups", None) is not None:
                raise ValueError("decorate the model before the optimizer's "
                                 "first step: its flat buffers hold the "
                                 "parameters' old dtype")
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
        if master_weight is not False:
            for o in opt_list:
                o._multi_precision = True
    if optimizers is None:
        return models
    return models, optimizers


def _scale_update(scale, good, bad, found, incr_ratio, decr_ratio,
                  incr_every, decr_every):
    """The reference's dynamic schedule (_scale_update_fn), on the device:
    a streak of `decr_every` overflowing steps multiplies the scale by
    decr_ratio (never below 1), one of `incr_every` clean steps by
    incr_ratio; each resets its count."""
    hit = found > 0
    zero = torch.zeros_like(good)
    bad2 = torch.where(hit, bad + 1, zero)
    good2 = torch.where(hit, zero, good + 1)
    do_decr = hit & (bad2 >= decr_every)
    do_incr = ~hit & (good2 >= incr_every)
    new_scale = torch.where(
        do_decr, torch.clamp(scale * decr_ratio, min=1.0),
        torch.where(do_incr, scale * incr_ratio, scale))
    return (new_scale, torch.where(do_incr, zero, good2),
            torch.where(do_decr, zero, bad2))


class GradScaler:
    """paddle.amp.GradScaler: dynamic loss scaling with the reference's
    incr_every_n_steps / decr_every_n_nan_or_inf schedule. Its tensors live
    on the device of the first loss it scales."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = torch.zeros((), dtype=torch.int32)
        self._bad_steps = torch.zeros((), dtype=torch.int32)
        self._found_inf_t = torch.zeros((), dtype=torch.float32)
        self._unscaled = False  # the reference's OptimizerState.UNSCALED

    def _to(self, device):
        if self._scale.device != device:
            self._scale = self._scale.to(device)
            self._good_steps = self._good_steps.to(device)
            self._bad_steps = self._bad_steps.to(device)
            self._found_inf_t = self._found_inf_t.to(device)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._enable and self._dynamic

    def get_loss_scaling(self):
        return float(self._scale)

    @property
    def _found_inf(self):
        return bool(self._found_inf_t > 0)

    def scale(self, var):
        if not self._enable:
            return var
        self._to(var.device)
        return var * self._scale.to(var.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale, in its own dtype and in place
        (the inverse cast to it, as the reference's `inv_scale.astype(
        g.dtype)`), and set found-inf if any unscaled element is not
        finite: one flag a gradient, reduced into one device scalar, no
        host read. At most once a step."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if not grads:
            self._found_inf_t = torch.zeros_like(self._found_inf_t)
            return
        self._to(grads[0].device)
        inv = 1.0 / self._scale
        bad = []
        for g in grads:
            g.mul_(inv.to(g.dtype))
            bad.append(~torch.isfinite(g).all())
        self._found_inf_t = torch.stack(bad).any().float()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:  # the step's one host read
            optimizer.step()
        self._update_scale()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        """The scale is updated in step(); kept for the reference's API."""

    def _update_scale(self):
        if not self._dynamic:
            return
        self._scale, self._good_steps, self._bad_steps = _scale_update(
            self._scale, self._good_steps, self._bad_steps,
            self._found_inf_t, self._incr_ratio, self._decr_ratio,
            self._incr_every_n_steps, self._decr_every_n)

    def state_dict(self):
        return {
            "scale": float(self._scale),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "good_steps": int(self._good_steps),
            "bad_steps": int(self._bad_steps),
        }

    def load_state_dict(self, state):
        dev = self._scale.device
        self._scale = torch.tensor(float(state["scale"]),
                                   dtype=torch.float32, device=dev)
        self._good_steps = torch.tensor(int(state.get("good_steps", 0)),
                                        dtype=torch.int32, device=dev)
        self._bad_steps = torch.tensor(int(state.get("bad_steps", 0)),
                                       dtype=torch.int32, device=dev)


class LossScaleBackoff:
    """Drives a GradScaler's dynamic scale from a NaN-guarded TrainStep's
    skip verdicts, with the scaler's own schedule: skipped steps shrink the
    loss scale, clean streaks grow it back."""

    def __init__(self, scaler: GradScaler):
        self.scaler = scaler
        self.skipped_steps = 0

    @property
    def scale(self) -> float:
        return float(self.scaler._scale)

    def on_step(self, skipped: bool):
        sc = self.scaler
        if sc.is_use_dynamic_loss_scaling():
            sc._found_inf_t = torch.full_like(sc._found_inf_t,
                                              1.0 if skipped else 0.0)
            sc._update_scale()
        self.skipped_steps += int(bool(skipped))


def _is_cuda(device):
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def is_float16_supported(device=None):
    """fp16 compute: True on a CUDA device (the card's tensor cores run
    fp16 at the bf16 rate)."""
    return _is_cuda(device)


def is_bfloat16_supported(device=None):
    """bf16 compute: True on a CUDA device (the port's only card, the H100,
    runs bf16 on its tensor cores)."""
    return _is_cuda(device)
