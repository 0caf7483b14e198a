"""Rotary position embedding (rotate-half): Triton kernels for contiguous and
per-token positions, and their plain PyTorch versions.

Replaces paddle_tpu/ops/pallas/rope.py `_rope_kernel` (via `_apply`,
contiguous positions, cos/sin [s, d]) and `_rope_packed_kernel` (via
`_apply_packed`, per-token positions pos2d [b, s] into cos/sin tables
[P, d], clamped to [0, P-1]). Both compute out = x*cos + rot(x)*sin with
rot(x) = [-x2, x1] in fp32 and cast to x's dtype once.

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


def _rotate(xf, cos, sin):
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return xf * cos + rot * sin


def rope_plain(x, cos, sin):
    """x [b, s, h, d]; cos, sin [s, d]."""
    out = _rotate(x.float(), cos.float()[None, :, None, :],
                  sin.float()[None, :, None, :])
    return out.to(x.dtype)


def rope_packed_plain(x, cos_tab, sin_tab, pos2d):
    """x [b, s, h, d]; cos/sin tables [P, d]; pos2d [b, s], clamped to
    [0, P-1] as the TPU kernel clamps."""
    idx = pos2d.long().clamp(0, cos_tab.shape[0] - 1)
    cos = cos_tab.float()[idx][:, :, None, :]
    sin = sin_tab.float()[idx][:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


@functools.cache
def _triton_kernel():
    global triton, tl
    triton, tl = _build.import_triton()

    @triton.jit
    def _rope_fwd(x_ptr, cos_ptr, sin_ptr, pos_ptr, o_ptr, s, h, d, P,
                  PACKED: tl.constexpr, BLOCK_H: tl.constexpr,
                  BLOCK_HALF: tl.constexpr):
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
        o1 = x1 * c1 - x2 * s1
        o2 = x2 * c2 + x1 * s2
        ty = o_ptr.dtype.element_ty
        tl.store(o_ptr + offs, o1.to(ty), mask=mask)
        tl.store(o_ptr + offs + half, o2.to(ty), mask=mask)

    return _rope_fwd


def _launch(wrapper, x, cos, sin, pos2d):
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
                       BLOCK_H=triton.next_power_of_2(h),
                       BLOCK_HALF=triton.next_power_of_2(d // 2), num_warps=4)
        wrapper.launches += 1
    return out


def rope(x, cos, sin):
    """Rotate-half RoPE of x [b, s, h, d] with cos/sin [s, d] (fp32). CUDA
    tensors launch the Triton kernel, CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin)
    if x.device.type != "cuda":
        raise ValueError(f"rope: no kernel for {x.device}")
    return _launch(rope, x, cos, sin, None)


def rope_packed(x, cos_tab, sin_tab, pos2d):
    """RoPE of x [b, s, h, d] at per-token positions pos2d [b, s] into fp32
    tables [P, d], positions clamped to [0, P-1]. CUDA tensors launch the
    Triton kernel, CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return rope_packed_plain(x, cos_tab, sin_tab, pos2d)
    if x.device.type != "cuda":
        raise ValueError(f"rope_packed: no kernel for {x.device}")
    return _launch(rope_packed, x, cos_tab, sin_tab, pos2d)


rope.launches = 0
rope_packed.launches = 0


def fused_rope(q, k, cos, sin):
    """q, k [b, s, h, d]; cos, sin [s, d] (paddle_tpu fused_rope)."""
    return rope(q, cos, sin), rope(k, cos, sin)


def fused_rope_packed(q, k, cos_tab, sin_tab, pos2d):
    """q, k [b, s, h, d]; tables [P, d]; pos2d [b, s]
    (paddle_tpu fused_rope_packed)."""
    return (rope_packed(q, cos_tab, sin_tab, pos2d),
            rope_packed(k, cos_tab, sin_tab, pos2d))
