"""Optimizers (counterpart of paddle_tpu/optimizer)."""
from .optimizer import Optimizer
from .optimizers import AdamW

__all__ = ["Optimizer", "AdamW"]
