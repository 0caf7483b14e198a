"""Runtime flag registry (counterpart of paddle_tpu/core/flags.py).

One typed registry with an environment override (FLAGS_xxx). The kernel
switches are defined here (reference core/flags.py:90,99); the serving
flags are defined by the modules that read them.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class _Flag:
    name: str
    default: Any
    value: Any
    doc: str
    type: type


_registry: Dict[str, _Flag] = {}
_lock = threading.Lock()


def _coerce(ty, raw):
    if ty is bool:
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return ty(raw)


def define_flag(name: str, default, doc: str = ""):
    ty = type(default)
    value = default
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        value = _coerce(ty, env)
    with _lock:
        _registry[name] = _Flag(name, default, value, doc, ty)
    return value


def get_flag(name: str):
    return _registry[name].value


def set_flags(flags: Dict[str, Any]):
    for name, v in flags.items():
        f = _registry.get(name)
        if f is None:
            raise KeyError(f"Unknown flag {name!r}; known: {sorted(_registry)}")
        f.value = _coerce(f.type, v)


define_flag("use_flash_attention", True,
            "scaled_dot_product_attention takes the flash kernels when "
            "supports() admits the shapes.")
define_flag("use_fused_adamw", True,
            "AdamW.step updates each parameter group with one fused kernel "
            "launch; off, it runs the reference's per-parameter Adam rule.")
