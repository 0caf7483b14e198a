"""Training step (counterpart of paddle_tpu/jit)."""
from .trainer import TrainStep

__all__ = ["TrainStep"]
