"""paddle.save / paddle.load (counterpart of paddle_tpu/framework/io.py).

Pickles nested containers with tensors turned into numpy payloads, as the
reference does. `save` is atomic: it pickles to `path + ".tmp"`, fsyncs and
`os.replace`s, so a crash mid-write never leaves a truncated file at the
destination (the chaos point `io.save.before_replace` sits before the
replace).

The reference pickles its own `paddle_tpu.framework.io._TensorPayload`.
`load` reads such a file without importing the reference: its unpickler
maps that class name to this module's `_TensorPayload`, which has the same
fields. `save` writes this module's class. bfloat16 has no numpy type
without ml_dtypes, which the port does not need: a bf16 tensor is stored as
its raw 2-byte words (uint16) with `dtype = "bfloat16"` on the payload, and
a reference file's ml_dtypes bfloat16 array (readable only where ml_dtypes
is installed) is read through the same words.

`load` places tensors on `device` (None: the current CUDA device, raising
without one; "cpu" on the host); `return_numpy=True` returns numpy arrays
instead, a bf16 one widened to float32 (exactly).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.place import resolve_device
from ..resilience import chaos

_REFERENCE_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class _TensorPayload:
    def __init__(self, array, is_param, name, trainable=True,
                 stop_gradient=True, dtype=None):
        self.array = array
        self.is_param = is_param
        self.name = name
        self.trainable = trainable
        self.stop_gradient = stop_gradient
        self.dtype = dtype      # "bfloat16" for raw bf16 words, else None


def _pack(obj):
    if torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous()
        dtype = None
        if t.dtype == torch.bfloat16:
            t, dtype = t.view(torch.int16), "bfloat16"
        arr = t.numpy()
        if dtype is not None:
            arr = arr.view(np.uint16)
        return _TensorPayload(arr, isinstance(obj, torch.nn.Parameter), "",
                              trainable=obj.requires_grad,
                              stop_gradient=not obj.requires_grad,
                              dtype=dtype)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(_pack(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _words(payload):
    """(numpy array, is_bf16): a bf16 payload's array as uint16 words."""
    arr = np.asarray(payload.array)
    if getattr(payload, "dtype", None) == "bfloat16" or \
            arr.dtype.name == "bfloat16":
        return np.ascontiguousarray(arr).view(np.uint16), True
    return arr, False


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        arr, bf16 = _words(obj)
        if return_numpy:
            if bf16:    # widened exactly: bf16 is fp32's top 16 bits
                return (arr.astype(np.uint32) << 16).view(np.float32)
            return arr
        t = torch.from_numpy(np.array(arr))
        if bf16:
            t = t.view(torch.int16).view(torch.bfloat16)
        t = t.to(device)
        if obj.is_param:
            return torch.nn.Parameter(
                t, requires_grad=bool(getattr(obj, "trainable", True)))
        return t.requires_grad_(not getattr(obj, "stop_gradient", True)
                                and t.is_floating_point())
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(_unpack(v, return_numpy, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _REFERENCE_PAYLOAD:
            return _TensorPayload
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    """Atomic save: pickle to `path + ".tmp"`, fsync, then os.replace: a
    crash mid-write can never leave a truncated file at the destination
    (it keeps its old content or gets the complete new one)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)
        f.flush()
        os.fsync(f.fileno())
        chaos.crash_point("io.save.before_replace")
    os.replace(tmp, path)


def load(path, return_numpy=False, device=None, **configs):
    """The object `save` (or the reference's paddle.save) wrote, tensors
    on `device` (see the module note)."""
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy, dev)
