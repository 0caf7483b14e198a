"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Holds the parameter list, the learning rate, the gradient clip and the
per-parameter state; subclasses implement `step()`. Parameters are named
param_0, param_1, ... by their position in the list (the reference names
them by creation order); the names are what `apply_decay_param_fun` sees.
"""
from __future__ import annotations

from typing import Dict

import torch


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if multi_precision:
            raise NotImplementedError(
                "multi_precision (fp32 master weights of low-precision "
                "parameters) is the ROADMAP item 'amp O2'")
        if weight_decay:
            raise NotImplementedError(
                "coupled (L2) weight decay: no optimizer of the port uses it "
                "yet; AdamW's decay is decoupled")
        self._parameter_list = list(parameters)
        self._names: Dict[int, str] = {
            id(p): f"param_{i}" for i, p in enumerate(self._parameter_list)}
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._state: Dict[int, Dict[str, object]] = {}
        self._step_count = 0

    def get_lr(self) -> float:
        return float(self._learning_rate)

    def _init_state(self, p) -> Dict[str, object]:
        return {}

    def _get_state(self, p):
        s = self._state.get(id(p))
        if s is None:
            s = self._state[id(p)] = self._init_state(p)
        return s

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
