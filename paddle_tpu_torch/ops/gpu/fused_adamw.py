"""Fused AdamW update over flat buffers: a Triton kernel and its plain
PyTorch version.

Replaces paddle_tpu/ops/pallas/fused_adamw.py `_adamw_kernel` (via
`fused_adamw_update`). Both versions compute what that kernel computes, in
fp32, with the same eight scalars (lr, beta1, beta2, eps, weight decay, the
two bias corrections 1 - beta**t, and a gradient scale):

    g = g * grad_scale
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)

The port updates p, m and v IN PLACE (the reference returns new arrays and
its trainer donates the old ones); the optimizer keeps every parameter,
gradient and moment of a group as a view of one flat buffer, so a step is
one launch over the group with nothing concatenated.

What bounds it on the H100: bytes. Each element reads p, g, m, v and writes
p, m, v, 28 bytes in fp32, for ~15 flops, far below the card's ~20 fp32
flops per byte. One program streams BLOCK contiguous elements with 16-byte
accesses per thread and keeps nothing between programs, the counterpart of
the TPU kernel's chunked pass through VMEM; the ragged tail is masked, so
the TPU's padding copy has no counterpart. The gradient scale may be a
device scalar (the global-norm clip's factor), read by every program, so
clipping needs no host sync and no scaled copy of the gradients. Division
and square root round to nearest (div_rn, sqrt_rn) as torch's do.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

# Bound by _triton_kernel on first launch (see fused_norm.py).
triton = tl = None
BLOCK = 2048


def f32(x):
    """A host scalar rounded to float32, as the reference's fp32 scalars."""
    return float(np.float32(x))


def adamw_plain(p, g, m, v, lr, beta1, beta2, eps, weight_decay,
                bias_correction1, bias_correction2, grad_scale=1.0):
    """The update in torch, in place on fp32 p, m, v; returns (p, m, v).
    `grad_scale` is a float or a 0-d float32 tensor on p's device."""
    b1, b2 = f32(beta1), f32(beta2)
    g = g.float() * grad_scale
    m.mul_(b1).add_(g, alpha=f32(np.float32(1) - np.float32(b1)))
    v.mul_(b2).addcmul_(g, g, value=f32(np.float32(1) - np.float32(b2)))
    denom = (v / f32(bias_correction2)).sqrt_().add_(f32(eps))
    upd = (m / f32(bias_correction1)).div_(denom)
    upd.add_(p, alpha=f32(weight_decay))
    p.sub_(upd, alpha=f32(lr))
    return p, m, v


@functools.cache
def _triton_kernel():
    global triton, tl
    triton, tl = _build.import_triton()

    @triton.jit
    def _adamw(p_ptr, g_ptr, m_ptr, v_ptr, scale_ptr, n, lr, beta1, beta2,
               eps, wd, bc1, bc2, gscale, HAS_SCALE_PTR: tl.constexpr,
               BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        p = tl.load(p_ptr + offs, mask=mask, other=0.0)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        m = tl.load(m_ptr + offs, mask=mask, other=0.0)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0)
        g = g * gscale
        if HAS_SCALE_PTR:
            g = g * tl.load(scale_ptr)
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * g * g
        mhat = tl.div_rn(m, bc1)
        vhat = tl.div_rn(v, bc2)
        upd = tl.div_rn(mhat, tl.sqrt_rn(vhat) + eps) + wd * p
        p = p - lr * upd
        tl.store(p_ptr + offs, p, mask=mask)
        tl.store(m_ptr + offs, m, mask=mask)
        tl.store(v_ptr + offs, v, mask=mask)

    return _adamw


def _kernel(p, g, m, v, lr, beta1, beta2, eps, weight_decay,
            bias_correction1, bias_correction2, grad_scale):
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"fused_adamw kernel takes 1-D float32 buffers; "
                            f"{name} is {t.dtype} {tuple(t.shape)}")
        if t.device != p.device or not t.is_contiguous():
            raise ValueError("fused_adamw kernel takes contiguous buffers on "
                             "one device")
        if t.numel() != p.numel():
            raise ValueError("fused_adamw: buffers differ in length")
    scale_t = None
    if torch.is_tensor(grad_scale):
        scale_t = grad_scale
        if scale_t.numel() != 1 or scale_t.dtype != torch.float32 \
                or scale_t.device != p.device:
            raise ValueError("fused_adamw: a tensor grad_scale must be one "
                             "float32 value on the buffers' device")
        grad_scale = 1.0
    kern = _triton_kernel()
    n = p.numel()
    if n:
        kern[(triton.cdiv(n, BLOCK),)](
            p, g, m, v, scale_t if scale_t is not None else p, n,
            f32(lr), f32(beta1), f32(beta2), f32(eps),
            f32(weight_decay), f32(bias_correction1),
            f32(bias_correction2), f32(grad_scale),
            HAS_SCALE_PTR=scale_t is not None, BLOCK=BLOCK, num_warps=8)
        fused_adamw.launches += 1
    return p, m, v


def fused_adamw(p, g, m, v, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, bias_correction1, bias_correction2,
                grad_scale=1.0):
    """One AdamW step on flat 1-D float32 buffers, in place; returns
    (p, m, v). CUDA tensors launch the Triton kernel, CPU tensors take the
    plain version."""
    args = (lr, beta1, beta2, eps, weight_decay, bias_correction1,
            bias_correction2, grad_scale)
    if p.device.type == "cpu":
        return adamw_plain(p, g, m, v, *args)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw: no kernel for {p.device}")
    return _kernel(p, g, m, v, *args)


fused_adamw.launches = 0
