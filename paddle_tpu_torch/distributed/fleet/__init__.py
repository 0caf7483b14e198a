"""Fleet utilities (counterpart of paddle_tpu/distributed/fleet):
activation recomputation."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
