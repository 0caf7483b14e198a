"""Runtime flag registry (counterpart of paddle_tpu/core/flags.py).

One typed registry with an environment override (FLAGS_xxx). Only the flags
the serving slice reads are defined here, by the modules that read them.
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
