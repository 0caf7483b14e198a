"""Distributed training (counterpart of paddle_tpu/distributed): only the
single-device `fleet.recompute` is ported yet; the mesh, collectives and
sharded state wait for the distributed slice."""
