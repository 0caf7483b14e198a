"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` beside it is the reference; this package never
imports it (nor JAX). Its layout mirrors paddle_tpu (core/, ops/, nn/,
models/, serving/, jit/, amp/, optimizer/, io/, resilience/, framework/,
distributed/, profiler/, observability/). Entry points run on the CUDA
device unless the caller passes device="cpu"; with no GPU they raise
instead of falling back.
"""
