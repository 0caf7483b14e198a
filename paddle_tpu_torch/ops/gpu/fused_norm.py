"""RMSNorm forward: a Triton kernel and its plain PyTorch version.

Replaces paddle_tpu/ops/pallas/fused_norm.py `_fwd_kernel` (via `_run_fwd`).
Both versions compute what that kernel computes: statistics in fp32 and
y = (x * rstd * w) in fp32, cast to x's dtype once at the end. (The
reference's XLA fallback, nn_ops.rms_norm:227-231, casts before the weight
multiply; in bf16 that differs from the kernel by one rounding, and the port
follows the kernel.)

What bounds it on the H100: bytes. Each row is read once and written once
with ~4 flops per element. One program owns one whole row (d = 4096 fits a
block of registers), so the row is read from device memory once for both
passes (sum of squares, then scale), the counterpart of the TPU kernel
keeping its row block in VMEM. The weight row stays in L2 across programs.
The TPU kernel's 256-row blocks and row padding have no counterpart: a GPU
program per row needs neither.
"""
import functools

import torch

from . import _build

# Bound by _triton_kernel on first launch: the jitted body looks its names up
# in this module's globals, and importing triton at module import would
# break CPU-only installs.
triton = tl = None


def rms_norm_plain(x, weight, eps):
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(x.dtype)


@functools.cache
def _triton_kernel():
    global triton, tl
    triton, tl = _build.import_triton()

    @triton.jit
    def _rms_fwd(x_ptr, w_ptr, y_ptr, d, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask,
                    other=0.0).to(tl.float32)
        rstd = tl.rsqrt(tl.sum(x * x, axis=0) / d + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * rstd * w
        tl.store(y_ptr + row * d + cols, y.to(y_ptr.dtype.element_ty),
                 mask=mask)

    return _rms_fwd


def _kernel(x, weight, eps):
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"fused_rms_norm kernel: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(f"fused_rms_norm: weight {tuple(weight.shape)} on "
                         f"{weight.device} does not match x [..., {d}] on "
                         f"{x.device}")
    if not x.is_contiguous() or not weight.is_contiguous():
        raise ValueError("fused_rms_norm kernel takes contiguous tensors")
    kern = _triton_kernel()
    y = torch.empty_like(x)
    n = x.numel() // d
    if n:
        block = triton.next_power_of_2(d)
        kern[(n,)](x, weight, y, d, float(eps), BLOCK_D=block,
                   num_warps=min(16, max(1, block // 256)))
        fused_rms_norm.launches += 1
    return y


def fused_rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last axis; weight [d]. CUDA tensors launch the
    Triton kernel, CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rms_norm: no kernel for {x.device}")
    return _kernel(x, weight, eps)


fused_rms_norm.launches = 0
