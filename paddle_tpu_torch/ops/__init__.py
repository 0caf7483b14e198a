"""Ops: the counterparts of paddle_tpu/ops/kernels/nn_ops.py that the port
uses (nn_ops) over the hand-written Hopper kernels in gpu/."""
