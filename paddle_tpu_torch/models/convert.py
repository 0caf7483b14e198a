"""Carry weights from the JAX reference into the port, and back."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..distributed.mesh import shard_block


def _tensors(model):
    """{state_dict name: the parameter or buffer itself} (a parameter,
    not state_dict's detached tensor, carries its mp cut)."""
    own = dict(model.named_parameters(remove_duplicate=False))
    own.update(model.named_buffers(remove_duplicate=False))
    return {name: own.get(name, t) for name, t in model.state_dict().items()}


def load_jax_state_dict(model: torch.nn.Module,
                        np_state: Dict[str, np.ndarray]) -> None:
    """Fill `model` in place from a paddle_tpu `Layer.state_dict()` given as
    numpy arrays by name. The key sets and every shape must match exactly
    (the port keeps the reference's parameter names and [in, out] linear
    layout); a parameter cut over an mp group (tensor parallelism) takes
    this rank's block of the reference's whole array, by its `_pspec`.
    Values are cast to each parameter's dtype and device. Raises
    ValueError on any mismatch, before anything is written."""
    own = _tensors(model)
    missing = sorted(set(own) - set(np_state))
    extra = sorted(set(np_state) - set(own))
    if missing or extra:
        raise ValueError(f"state_dict keys differ: missing {missing}, "
                         f"unexpected {extra}")
    arrays = {}
    for name, t in own.items():
        a = np.asarray(np_state[name])
        if getattr(t, "_mp_shard", None) is not None:
            if tuple(a.shape) != tuple(t._full_shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != the "
                                 f"whole {tuple(t._full_shape)}")
            a = shard_block(a, t)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                             f"{tuple(t.shape)}")
        # a writable contiguous copy; bfloat16 (an ml_dtypes extension
        # numpy type torch cannot read) goes through float32 exactly
        bf16 = a.dtype.kind == "V" or a.dtype.name == "bfloat16"
        arrays[name] = np.array(a, dtype=np.float32 if bf16 else a.dtype)
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(torch.from_numpy(arrays[name]))


def gather_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's state_dict as whole numpy arrays (bf16 and fp16 as
    float32): each mp block all-gathered over its group, so every rank of
    the group must call it. The reference's layout, for the tests and
    the card's comparisons."""
    from ..distributed.collective import all_gather_concat

    out = {}
    for name, t in _tensors(model).items():
        cut = getattr(t, "_mp_shard", None)
        with torch.no_grad():
            whole = t.detach() if cut is None else \
                all_gather_concat(t.detach().contiguous(), cut[1], cut[0])
        if whole.dtype in (torch.bfloat16, torch.float16):
            whole = whole.float()
        elif whole.device.type == "cpu" and cut is None:
            whole = whole.clone()        # not a view of the live parameter
        out[name] = whole.cpu().numpy()
    return out
