"""Fused AdamW update over flat buffers: a Triton kernel and its plain
PyTorch version, in two forms.

Replaces paddle_tpu/ops/pallas/fused_adamw.py `_adamw_kernel` (via
`fused_adamw_update`). Both versions compute what that kernel computes, in
fp32, with the same eight scalars (lr, beta1, beta2, eps, weight decay, the
two bias corrections 1 - beta**t, and a gradient scale):

    g = g * grad_scale
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)

The fp32 form (`fused_adamw`) updates fp32 parameters. The master form
(`fused_adamw_master`, amp O2) updates the fp32 master weights of bf16 or
fp16 parameters from gradients in the parameters' dtype, and writes the
parameters' low-precision copy, master.to(dtype) rounded to nearest even,
in the same pass: the reference's compiled step updates the master through
the same formula and casts it (optimizer.py functional_update). A scaled
low-precision gradient is rounded to its own dtype before the update, as
the reference's ClipGradByGlobalNorm.functional_clip returns
(g.astype(f32) * scale).astype(g.dtype); for an fp32 gradient, or a scale
of 1, that rounding changes nothing.

The port updates in place (the reference returns new arrays and its
trainer donates the old ones); the optimizer keeps every parameter,
gradient, master and moment of a group as a view of one flat buffer, so a
step is one launch over the group with nothing concatenated.

What bounds it on the H100: bytes. An element reads p (or the master), g,
m, v and writes p, m, v: 28 bytes in fp32; the master form reads a 2-byte
gradient and writes a 2-byte copy, 28 bytes too. That is ~15 flops an
element, far below the card's ~20 fp32 flops per byte. One program streams
BLOCK contiguous elements with 16-byte accesses per thread and keeps
nothing between programs, the counterpart of the TPU kernel's chunked pass
through VMEM; the ragged tail is masked, so the TPU's padding copy has no
counterpart. The gradient scale may be a device scalar (the global-norm
clip's factor) and so may a skip flag (TrainStep's NaN guard): every
program reads them, so neither needs a host sync; with the flag set the
masks are empty and the launch reads and stores nothing. Division and
square root round to nearest (div_rn, sqrt_rn) as torch's do.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, _counts

# Bound by _triton_kernel on first launch (see fused_norm.py).
triton = tl = None
BLOCK = 2048
_LOW = (torch.bfloat16, torch.float16)


def f32(x):
    """A host scalar rounded to float32, as the reference's fp32 scalars."""
    return float(np.float32(x))


def adamw_plain(p, g, m, v, lr, beta1, beta2, eps, weight_decay,
                bias_correction1, bias_correction2, grad_scale=1.0,
                skip=None, low=None):
    """The update in torch, in place on fp32 p, m, v; returns (p, m, v).
    `grad_scale` is a float or a 0-d float32 tensor on p's device; a
    low-precision g is rounded to its dtype after scaling. With `low` (the
    master form) p holds the master and low receives p in low's dtype.
    A nonzero `skip` (0-d tensor) leaves every buffer as it is."""
    if skip is not None and bool(skip):
        return p, m, v
    b1, b2 = f32(beta1), f32(beta2)
    gf = g.float() * grad_scale
    if g.dtype != torch.float32:
        gf = gf.to(g.dtype).float()
    m.mul_(b1).add_(gf, alpha=f32(np.float32(1) - np.float32(b1)))
    v.mul_(b2).addcmul_(gf, gf, value=f32(np.float32(1) - np.float32(b2)))
    denom = (v / f32(bias_correction2)).sqrt_().add_(f32(eps))
    upd = (m / f32(bias_correction1)).div_(denom)
    upd.add_(p, alpha=f32(weight_decay))
    p.sub_(upd, alpha=f32(lr))
    if low is not None:
        low.copy_(p)
    return p, m, v


@functools.cache
def _triton_kernel():
    global triton, tl
    triton, tl = _build.import_triton()

    @triton.jit
    def _adamw(p_ptr, g_ptr, m_ptr, v_ptr, low_ptr, scale_ptr, skip_ptr, n,
               lr, beta1, beta2, eps, wd, bc1, bc2, gscale,
               HAS_SCALE_PTR: tl.constexpr, HAS_SKIP: tl.constexpr,
               HAS_LOW: tl.constexpr, ROUND_G: tl.constexpr,
               BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        if HAS_SKIP:
            mask = mask & (tl.load(skip_ptr) == 0)
        p = tl.load(p_ptr + offs, mask=mask, other=0.0)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        m = tl.load(m_ptr + offs, mask=mask, other=0.0)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0)
        g = g * gscale
        if HAS_SCALE_PTR:
            g = g * tl.load(scale_ptr)
        if ROUND_G:
            g = g.to(g_ptr.dtype.element_ty).to(tl.float32)
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * g * g
        mhat = tl.div_rn(m, bc1)
        vhat = tl.div_rn(v, bc2)
        upd = tl.div_rn(mhat, tl.sqrt_rn(vhat) + eps) + wd * p
        p = p - lr * upd
        tl.store(p_ptr + offs, p, mask=mask)
        tl.store(m_ptr + offs, m, mask=mask)
        tl.store(v_ptr + offs, v, mask=mask)
        if HAS_LOW:
            tl.store(low_ptr + offs, p.to(low_ptr.dtype.element_ty),
                     mask=mask)

    return _adamw


def _check(name, t, p, dtypes):
    if t.dtype not in dtypes or t.dim() != 1:
        raise TypeError(f"fused_adamw kernel: {name} must be a 1-D "
                        f"{'/'.join(str(d) for d in dtypes)} buffer, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.device != p.device or not t.is_contiguous():
        raise ValueError("fused_adamw kernel takes contiguous buffers on "
                         "one device")
    if t.numel() != p.numel():
        raise ValueError("fused_adamw: buffers differ in length")


def _scalar(name, t, p, dtype):
    if t.numel() != 1 or t.dtype != dtype or t.device != p.device:
        raise ValueError(f"fused_adamw: {name} must be one {dtype} value "
                         f"on the buffers' device")


def _kernel(p, g, m, v, low, lr, beta1, beta2, eps, weight_decay,
            bias_correction1, bias_correction2, grad_scale, skip):
    f32_only = (torch.float32,)
    for name, t in (("p", p), ("m", m), ("v", v)):
        _check(name, t, p, f32_only)
    _check("g", g, p, f32_only if low is None else _LOW + f32_only)
    if low is not None:
        _check("low", low, p, _LOW)
    scale_t = None
    if torch.is_tensor(grad_scale):
        scale_t = grad_scale
        _scalar("a tensor grad_scale", scale_t, p, torch.float32)
        grad_scale = 1.0
    if skip is not None:
        _scalar("skip", skip, p, torch.int32)
    kern = _triton_kernel()
    n = p.numel()
    if n:
        kern[(triton.cdiv(n, BLOCK),)](
            p, g, m, v, low if low is not None else p,
            scale_t if scale_t is not None else p,
            skip if skip is not None else p, n,
            f32(lr), f32(beta1), f32(beta2), f32(eps),
            f32(weight_decay), f32(bias_correction1),
            f32(bias_correction2), f32(grad_scale),
            HAS_SCALE_PTR=scale_t is not None, HAS_SKIP=skip is not None,
            HAS_LOW=low is not None, ROUND_G=g.dtype != torch.float32,
            BLOCK=BLOCK, num_warps=8)
    return p, m, v


def _dispatch(wrapper, p, g, m, v, low, args, skip):
    if p.device.type == "cpu":
        return adamw_plain(p, g, m, v, *args, skip=skip, low=low)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw: no kernel for {p.device}")
    out = _kernel(p, g, m, v, low, *args, skip)
    if p.numel():
        _counts.count(wrapper)
    return out


def fused_adamw(p, g, m, v, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, bias_correction1, bias_correction2,
                grad_scale=1.0, skip=None):
    """One AdamW step on flat 1-D float32 buffers, in place; returns
    (p, m, v). `skip`, a 0-d int32 device tensor, stores nothing when
    nonzero. CUDA tensors launch the Triton kernel, CPU tensors take the
    plain version."""
    args = (lr, beta1, beta2, eps, weight_decay, bias_correction1,
            bias_correction2, grad_scale)
    return _dispatch(fused_adamw, p, g, m, v, None, args, skip)


def fused_adamw_master(master, g, m, v, low, *, lr, beta1=0.9, beta2=0.999,
                       eps=1e-8, weight_decay=0.0, bias_correction1,
                       bias_correction2, grad_scale=1.0, skip=None):
    """The master form: one AdamW step on a flat float32 master and its
    moments from a bf16 or fp16 gradient, in place, writing the master's
    copy into `low` (the parameters' flat buffer, in their dtype); returns
    (master, m, v). Otherwise as `fused_adamw`."""
    args = (lr, beta1, beta2, eps, weight_decay, bias_correction1,
            bias_correction2, grad_scale)
    return _dispatch(fused_adamw_master, master, g, m, v, low, args, skip)


fused_adamw.launches = 0
fused_adamw_master.launches = 0
