"""Optimizers (counterpart of paddle_tpu/optimizer)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import AdamW

__all__ = ["Optimizer", "AdamW", "lr"]
