"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Holds the parameter list, the learning rate (a float or an
`lr.LRScheduler`), the gradient clip and the per-parameter state;
subclasses implement `step()`. Parameters are named param_0, param_1, ...
by their position in the list (the reference names them by creation
order); the names are what `apply_decay_param_fun` sees and what
`state_dict()` keys carry.

`multi_precision` (set by `amp.decorate` under O2) gives every bf16 or
fp16 parameter an fp32 master weight, `state["master"]`, made from the
parameter's value when its state is first made, as the reference's
`_get_state` does: after `decorate` that value is already low precision,
so the master starts at fp32(bf16(p0)).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .lr import LRScheduler


def _assign(current, value):
    """`value` written into the live state entry `current` (a tensor, in
    place; a ZeRO-sharded entry, this rank's part of it; or a host
    float)."""
    if hasattr(current, "assign"):
        current.assign(value)
        return current
    if torch.is_tensor(current):
        current.copy_(torch.as_tensor(value))
        return current
    return float(value.item() if hasattr(value, "item") else value)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if weight_decay:
            raise NotImplementedError(
                "coupled (L2) weight decay: no optimizer of the port uses it "
                "yet; AdamW's decay is decoupled")
        self._parameter_list = list(parameters)
        self._names: Dict[int, str] = {
            id(p): f"param_{i}" for i, p in enumerate(self._parameter_list)}
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._state: Dict[int, Dict[str, object]] = {}
        self._step_count = 0

    # ---- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr is not allowed when lr is a scheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self) -> Optional[LRScheduler]:
        lr = self._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    # ---- state -------------------------------------------------------------
    def _init_state(self, p) -> Dict[str, object]:
        return {}

    def _get_state(self, p):
        s = self._state.get(id(p))
        if s is None:
            s = self._state[id(p)] = self._init_state(p)
        return s

    def _materialize_state(self):
        """Make every parameter's state (subclasses whose state is made
        lazily, at the first step)."""

    def step(self):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Zero every gradient (set_to_zero=True) or drop them (False, the
        reference's eager default)."""
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            elif not set_to_zero:
                p.grad = None

    # ---- state dict --------------------------------------------------------
    def state_dict(self):
        """The reference's layout: "{name}.{slot}" per state entry, the fp32
        masters under "master_weights", the scheduler's state under
        "LR_Scheduler" and the step count under "step". Tensors are the
        live state (views of the flat buffers), not copies; under ZeRO
        (distributed/sharding.py) an entry the ranks hold in parts is
        gathered whole, with the parameter's shape: a collective that every
        rank of the sharding group calls."""
        return self._state_dict(lazy=False)

    def _state_dict(self, lazy):
        """state_dict(); with `lazy`, ZeRO's sharded entries stay as they
        are (their `rows` is what a rank-sharded checkpoint writes)."""
        out = {"LR_Scheduler": {}, "master_weights": {}}
        sched = self._lr_scheduler
        if sched is not None:
            out["LR_Scheduler"] = sched.state_dict()
        for p in self._parameter_list:
            name = self._names[id(p)]
            for k, v in (self._state.get(id(p)) or {}).items():
                if not lazy and hasattr(v, "full"):
                    v = v.full()
                if k == "master":
                    out["master_weights"][name] = v
                else:
                    out[f"{name}.{k}"] = v
        out["step"] = self._step_count
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load a `state_dict()`: tensors are copied into the live state in
        place, so the flat buffers' views stay intact (under ZeRO each rank
        keeps its part of every whole entry)."""
        sched = self._lr_scheduler
        if sched is not None and state.get("LR_Scheduler"):
            sched.set_state_dict(state["LR_Scheduler"])
        self._step_count = int(state.get("step", 0))
        self._materialize_state()
        masters = state.get("master_weights", {})
        for p in self._parameter_list:
            name = self._names[id(p)]
            s = self._state.get(id(p))
            for k in list(s or ()):
                key = name if k == "master" else f"{name}.{k}"
                src = masters if k == "master" else state
                if key in src:
                    s[k] = _assign(s[k], src[key])
