"""Distributed training (counterpart of paddle_tpu/distributed): the
single-device `fleet.recompute` and, in `env`, the process environment
for one process, the in-process store and the serving fleet's replica
registry; the mesh, collectives, sharded state and stores across ranks
wait for the distributed slice."""
