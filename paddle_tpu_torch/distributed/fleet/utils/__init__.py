"""fleet.utils (counterpart of paddle_tpu/distributed/fleet/utils;
reference: python/paddle/distributed/fleet/utils/): `recompute` and
`recompute_sequential` re-exported, as
`paddle.distributed.fleet.utils.recompute`."""
from ..recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["recompute", "recompute_sequential"]
