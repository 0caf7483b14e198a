"""Carry weights from the JAX reference into the port."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_jax_state_dict(model: torch.nn.Module,
                        np_state: Dict[str, np.ndarray]) -> None:
    """Fill `model` in place from a paddle_tpu `Layer.state_dict()` given as
    numpy arrays by name. The key sets and every shape must match exactly
    (the port keeps the reference's parameter names and [in, out] linear
    layout); values are cast to each parameter's dtype and device. Raises
    ValueError on any mismatch, before anything is written."""
    own = model.state_dict()
    missing = sorted(set(own) - set(np_state))
    extra = sorted(set(np_state) - set(own))
    if missing or extra:
        raise ValueError(f"state_dict keys differ: missing {missing}, "
                         f"unexpected {extra}")
    arrays = {}
    for name, t in own.items():
        a = np.asarray(np_state[name])
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
