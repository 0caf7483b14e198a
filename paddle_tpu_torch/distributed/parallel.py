"""DataParallel (counterpart of paddle_tpu/distributed/parallel.py:17;
reference: Paddle's python/paddle/distributed/parallel.py:190 and its
EagerReducer).

Eager data parallelism by gradient hooks: with more than one rank (or a
group given), every trainable parameter's gradient is all-reduced over
the group as the backward produces it. The reference's hooks SUM the
gradients over the group (parallel.py:32-35), and so do these; Paddle's
own DataParallel averages them (ROADMAP, "Faults of the reference").
At world 1 it is the identity wrapper. `state_dict` and `set_state_dict`
pass through to the wrapped layers, so their keys carry no prefix.
"""
from __future__ import annotations

import torch

from .collective import ReduceOp, all_reduce, get_world_size


class DataParallel(torch.nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        if get_world_size() > 1 or group is not None:
            self._register_grad_hooks()

    def _register_grad_hooks(self):
        group = self._group

        def hook(grad):
            return all_reduce(grad.clone(), op=ReduceOp.SUM, group=group)

        for p in self._layers.parameters():
            if p.requires_grad:
                p.register_hook(hook)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        setter = getattr(self._layers, "set_state_dict", None)
        if setter is not None:
            return setter(state_dict, *args, **kwargs)
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass
