"""Hand-written Hopper kernels (counterpart of paddle_tpu/ops/pallas/).

Each module holds a kernel, its plain PyTorch version and a wrapper. The
wrapper launches the kernel for CUDA tensors (or raises) and takes the plain
version for CPU tensors; it counts its launches in a plain int attribute,
`<wrapper>.launches`, so a run can show which kernels its path went through.
A CUDA graph's replay runs no wrapper: its owner records the launches its
capture made (`recording()`, which keeps them out of the counts and apart
from other threads') and adds them at each replay (`add_launch_counts`).
"""
import contextlib

from . import (_counts, flash_attention, fused_adamw, fused_norm,
               paged_attention, rope)

KERNEL_WRAPPERS = {
    "rms_norm": fused_norm.fused_rms_norm,
    "rms_norm_bwd": fused_norm.fused_rms_norm_bwd,
    "rope": rope.rope,
    "rope_packed": rope.rope_packed,
    "paged_decode": paged_attention.paged_attention,
    "paged_verify": paged_attention.paged_attention_multi,
    "flash_fwd": flash_attention.flash_fwd,
    "flash_dq": flash_attention.flash_dq,
    "flash_dkv": flash_attention.flash_dkv,
    "flash_seg_fwd": flash_attention.flash_seg_fwd,
    "flash_seg_dq": flash_attention.flash_seg_dq,
    "flash_seg_dkv": flash_attention.flash_seg_dkv,
    "adamw": fused_adamw.fused_adamw,
    "adamw_master": fused_adamw.fused_adamw_master,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts(names=None) -> dict:
    """{name: launches} for every kernel, or for those named."""
    names = KERNEL_WRAPPERS if names is None else names
    return {name: KERNEL_WRAPPERS[name].launches for name in names}


def add_launch_counts(deltas: dict) -> None:
    """Add {name: launches} to the counts (a graph replay's launches)."""
    for name, n in deltas.items():
        _counts.add(KERNEL_WRAPPERS[name], n)


@contextlib.contextmanager
def recording():
    """Count the launches this thread's wrappers make in the block into
    the yielded {name: launches} dict instead of the counts (filled when
    the block ends): a CUDA graph capture's, which launch nothing."""
    names = {fn: name for name, fn in KERNEL_WRAPPERS.items()}
    out = {}
    with _counts.recording() as rec:
        yield out
    out.update({names[fn]: n for fn, n in rec.items()})
