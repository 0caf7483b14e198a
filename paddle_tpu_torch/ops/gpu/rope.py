"""Rotary position embedding (rotate-half): Triton kernels for contiguous and
per-token positions, and their plain PyTorch versions.

Replaces paddle_tpu/ops/pallas/rope.py `_rope_kernel` (via `_apply`,
contiguous positions, cos/sin [s, d]) and `_rope_packed_kernel` (via
`_apply_packed`, per-token positions pos2d [b, s] into cos/sin tables
[P, d], clamped to [0, P-1]). Both compute out = x*cos + sign*rot(x)*sin
with rot(x) = [-x2, x1] in fp32 and cast to x's dtype once. sign = -1 is the
transposed rotation: the backward of each is its forward with sign -1 on
the output's gradient (the reference's VJPs, rope.py:98-101 and :216-219),
launched on the same counter; `fused_rope` and `fused_rope_packed` join the
two in autograd Functions whose gradient flows to q and k only.

What bounds them on the H100: bytes. Each element of x is read once and
written once with ~3 flops, and one cos/sin row serves all heads of a token.
One program owns one token: it loads the token's cos/sin row once (fp32,
from L2 after the first head), loads both halves of every head as two masked
[heads, d/2] blocks (the rotate-half pairing needs no shuffle), and stores
both halves. The per-token kernel gathers its cos/sin row straight from the
table by position; the TPU's one-hot MXU lookup and its 4 MiB table budget
(`_packed_supported`, which sent P = 4096 tables to the XLA gather) have no
counterpart here. The two entry points share one jitted body; a constexpr
selects where the row index comes from.
"""
import functools

import torch

from . import _build

# Bound by _triton_kernel on first launch (see fused_norm.py).
triton = tl = None


def _rotate(xf, cos, sin, sign):
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    if sign < 0:
        rot = -rot
    return xf * cos + rot * sin


def _sign(sign):
    if sign not in (1, -1):
        raise ValueError(f"rope: sign must be 1 or -1, got {sign}")
    return sign


def rope_plain(x, cos, sin, sign=1):
    """x [b, s, h, d]; cos, sin [s, d]."""
    out = _rotate(x.float(), cos.float()[None, :, None, :],
                  sin.float()[None, :, None, :], _sign(sign))
    return out.to(x.dtype)


def rope_packed_plain(x, cos_tab, sin_tab, pos2d, sign=1):
    """x [b, s, h, d]; cos/sin tables [P, d]; pos2d [b, s], clamped to
    [0, P-1] as the TPU kernel clamps."""
    idx = pos2d.long().clamp(0, cos_tab.shape[0] - 1)
    cos = cos_tab.float()[idx][:, :, None, :]
    sin = sin_tab.float()[idx][:, :, None, :]
    return _rotate(x.float(), cos, sin, _sign(sign)).to(x.dtype)


@functools.cache
def _triton_kernel():
    global triton, tl
    triton, tl = _build.import_triton()

    @triton.jit
    def _rope_fwd(x_ptr, cos_ptr, sin_ptr, pos_ptr, o_ptr, s, h, d, P,
                  PACKED: tl.constexpr, SIGN: tl.constexpr,
                  BLOCK_H: tl.constexpr, BLOCK_HALF: tl.constexpr):
        tok = tl.program_id(0).to(tl.int64)      # flat index over b * s
        if PACKED:
            p = tl.load(pos_ptr + tok).to(tl.int64)
            p = tl.minimum(tl.maximum(p, 0), P - 1)
        else:
            p = tok % s
        half = d // 2
        cols = tl.arange(0, BLOCK_HALF)
        cmask = cols < half
        c1 = tl.load(cos_ptr + p * d + cols, mask=cmask, other=0.0)[None, :]
        c2 = tl.load(cos_ptr + p * d + half + cols, mask=cmask,
                     other=0.0)[None, :]
        s1 = tl.load(sin_ptr + p * d + cols, mask=cmask, other=0.0)[None, :]
        s2 = tl.load(sin_ptr + p * d + half + cols, mask=cmask,
                     other=0.0)[None, :]
        heads = tl.arange(0, BLOCK_H)[:, None]
        mask = (heads < h) & cmask[None, :]
        offs = tok * h * d + heads * d + cols[None, :]
        x1 = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x2 = tl.load(x_ptr + offs + half, mask=mask, other=0.0).to(tl.float32)
        if SIGN < 0:      # the transposed rotation: rot(x) -> -rot(x)
            x1s = -x1
            x2s = -x2
        else:
            x1s = x1
            x2s = x2
        o1 = x1 * c1 - x2s * s1
        o2 = x2 * c2 + x1s * s2
        ty = o_ptr.dtype.element_ty
        tl.store(o_ptr + offs, o1.to(ty), mask=mask)
        tl.store(o_ptr + offs + half, o2.to(ty), mask=mask)

    return _rope_fwd


def _launch(wrapper, x, cos, sin, pos2d, sign):
    """Check the operands, launch the kernel (counted on `wrapper`)."""
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rope: x must be [b, s, h, d] with even d; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rope kernel: unsupported dtype {x.dtype}")
    b, s, h, d = x.shape
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
            or cos.shape != sin.shape or cos.dim() != 2 or cos.shape[1] != d:
        raise ValueError("rope kernel: cos/sin must be fp32 [rows, d]")
    tensors = [x, cos, sin] + ([] if pos2d is None else [pos2d])
    for t in tensors:
        if t.device != x.device:
            raise ValueError("rope: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("rope kernel takes contiguous tensors")
    if pos2d is None:
        if cos.shape[0] != s:
            raise ValueError(f"rope: cos rows {cos.shape[0]} != seq {s}")
    elif tuple(pos2d.shape) != (b, s) or pos2d.dtype not in (torch.int32,
                                                             torch.int64):
        raise ValueError(f"rope: positions must be int [b, s] = {(b, s)}")
    kern = _triton_kernel()
    out = torch.empty_like(x)
    if x.numel():
        kern[(b * s,)](x, cos, sin, x if pos2d is None else pos2d, out, s, h,
                       d, cos.shape[0], PACKED=pos2d is not None,
                       SIGN=_sign(sign), BLOCK_H=triton.next_power_of_2(h),
                       BLOCK_HALF=triton.next_power_of_2(d // 2), num_warps=4)
        wrapper.launches += 1
    return out


def rope(x, cos, sin, sign=1):
    """Rotate-half RoPE of x [b, s, h, d] with cos/sin [s, d] (fp32); sign
    -1 rotates the other way. CUDA tensors launch the Triton kernel, CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin, sign)
    if x.device.type != "cuda":
        raise ValueError(f"rope: no kernel for {x.device}")
    return _launch(rope, x, cos, sin, None, sign)


def rope_packed(x, cos_tab, sin_tab, pos2d, sign=1):
    """RoPE of x [b, s, h, d] at per-token positions pos2d [b, s] into fp32
    tables [P, d], positions clamped to [0, P-1]; sign -1 rotates the other
    way. CUDA tensors launch the Triton kernel, CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return rope_packed_plain(x, cos_tab, sin_tab, pos2d, sign)
    if x.device.type != "cuda":
        raise ValueError(f"rope_packed: no kernel for {x.device}")
    return _launch(rope_packed, x, cos_tab, sin_tab, pos2d, sign)


rope.launches = 0
rope_packed.launches = 0


class RopeFunction(torch.autograd.Function):
    """rope(x, cos, sin); the gradient is rope(g, cos, sin, sign=-1)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope(g.contiguous(), cos, sin, sign=-1), None, None


class RopePackedFunction(torch.autograd.Function):
    """rope_packed(x, ...); the gradient is the same kernel with sign -1."""

    @staticmethod
    def forward(ctx, x, cos_tab, sin_tab, pos2d):
        ctx.save_for_backward(cos_tab, sin_tab, pos2d)
        return rope_packed(x, cos_tab, sin_tab, pos2d)

    @staticmethod
    def backward(ctx, g):
        cos_tab, sin_tab, pos2d = ctx.saved_tensors
        return (rope_packed(g.contiguous(), cos_tab, sin_tab, pos2d,
                            sign=-1), None, None, None)


def _differentiable(x):
    return torch.is_grad_enabled() and x.requires_grad


def fused_rope(q, k, cos, sin):
    """q, k [b, s, h, d]; cos, sin [s, d] (paddle_tpu fused_rope);
    differentiable in q and k. A tensor that wants no gradient (serving,
    under no_grad) goes to the kernel with no autograd node."""
    return tuple(RopeFunction.apply(x, cos, sin) if _differentiable(x)
                 else rope(x, cos, sin) for x in (q, k))


def fused_rope_packed(q, k, cos_tab, sin_tab, pos2d):
    """q, k [b, s, h, d]; tables [P, d]; pos2d [b, s]
    (paddle_tpu fused_rope_packed); differentiable in q and k, as
    fused_rope is."""
    return tuple(RopePackedFunction.apply(x, cos_tab, sin_tab, pos2d)
                 if _differentiable(x)
                 else rope_packed(x, cos_tab, sin_tab, pos2d)
                 for x in (q, k))
