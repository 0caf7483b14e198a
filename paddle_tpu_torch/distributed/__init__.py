"""Distributed training (counterpart of paddle_tpu/distributed): the
single-device `fleet.recompute` and, in `env`, the process environment,
the process-group store (in-process, or native.TCPStore across
processes) and the serving fleet's replica registry; the mesh,
collectives and sharded state wait for the distributed slice."""
