"""Hand-written Hopper kernels (counterpart of paddle_tpu/ops/pallas/).

Each module holds a kernel, its plain PyTorch version and a wrapper. The
wrapper launches the kernel for CUDA tensors (or raises) and takes the plain
version for CPU tensors; it counts its launches in a plain int attribute,
`<wrapper>.launches`, so a run can show which kernels its path went through.
"""
from . import flash_attention, fused_adamw, fused_norm, paged_attention, rope

KERNEL_WRAPPERS = {
    "rms_norm": fused_norm.fused_rms_norm,
    "rms_norm_bwd": fused_norm.fused_rms_norm_bwd,
    "rope": rope.rope,
    "rope_packed": rope.rope_packed,
    "paged_decode": paged_attention.paged_attention,
    "flash_fwd": flash_attention.flash_fwd,
    "flash_dq": flash_attention.flash_dq,
    "flash_dkv": flash_attention.flash_dkv,
    "flash_seg_fwd": flash_attention.flash_seg_fwd,
    "flash_seg_dq": flash_attention.flash_seg_dq,
    "flash_seg_dkv": flash_attention.flash_seg_dkv,
    "adamw": fused_adamw.fused_adamw,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts(names=None) -> dict:
    """{name: launches} for every kernel, or for those named."""
    names = KERNEL_WRAPPERS if names is None else names
    return {name: KERNEL_WRAPPERS[name].launches for name in names}
