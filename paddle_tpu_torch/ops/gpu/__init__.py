"""Hand-written Hopper kernels (counterpart of paddle_tpu/ops/pallas/).

Each module holds a kernel, its plain PyTorch version and a wrapper. The
wrapper launches the kernel for CUDA tensors (or raises) and takes the plain
version for CPU tensors; it counts its launches in a plain int attribute,
`<wrapper>.launches`, so a run can show which kernels its path went through.
"""
from . import fused_norm, paged_attention, rope

KERNEL_WRAPPERS = {
    "rms_norm": fused_norm.fused_rms_norm,
    "rope": rope.rope,
    "rope_packed": rope.rope_packed,
    "paged_decode": paged_attention.paged_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
