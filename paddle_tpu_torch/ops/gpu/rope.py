"""Rotary position embedding (rotate-half) of q and k: the CUDA kernel in
csrc/rope.cu, its plain PyTorch versions and the autograd Function that
joins them.

Replaces paddle_tpu/ops/pallas/rope.py `_rope_kernel` (via `_apply`,
contiguous positions, cos/sin [s, d]) and `_rope_packed_kernel` (via
`_apply_packed`, per-token positions pos2d [b, s] into cos/sin tables
[P, d], clamped to [0, P-1]). Both compute out = x*cos + sign*rot(x)*sin
with rot(x) = [-x2, x1] in fp32 and cast to x's dtype once. sign = -1 is the
transposed rotation: the backward of each is its forward with sign -1 on
the output's gradient (the reference's VJPs, rope.py:98-101 and :216-219).

One launch rotates q and k together (the reference makes one pallas_call
for each), so `fused_rope` and `fused_rope_packed` cost the host one ctypes
call a layer: the checks once, two output allocations, the stream's raw
handle and the call, with the argument types bound once. At decode the
kernel's device work is about a microsecond and that host path is the
call's cost. The source says how the kernel moves the bytes. The launches
count on `rope` (contiguous positions) and `rope_packed` (per-token), one a
fused call; `rope(x, ...)` and `rope_packed(x, ...)` are the same entry
with no k.
"""
import ctypes
import functools

import torch

from . import _build, _counts

# dtype codes of the C entry point (q, k and the outputs share one)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def rope_qk_plain(q, k, cos, sin, pos2d=None, sign=1):
    """(q', k') by the plain versions: contiguous positions (cos, sin
    [s, d]) where pos2d is None, else per-token; either of q, k may be
    None and stays None."""
    def one(x):
        if x is None:
            return None
        if pos2d is None:
            return rope_plain(x, cos, sin, sign)
        return rope_packed_plain(x, cos, sin, pos2d, sign)

    return one(q), one(k)


def _check(q, k, cos, sin, pos2d):
    """Raise unless the kernel takes these operands: q [b, s, hq, d] and
    k [b, s, hkv, d] (one may be None) of one dtype, d even; cos and sin
    fp32 [s, d] (contiguous positions) or [P, d] with int32 positions pos2d
    [b, s]; all contiguous, on one device."""
    x = q if q is not None else k
    if x is None:
        raise ValueError("rope: no tensor to rotate")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rope: x must be [b, s, h, d] with even d; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rope kernel: unsupported dtype {x.dtype}")
    b, s, _, d = x.shape
    if q is not None and k is not None and (
            k.dim() != 4 or k.shape[0] != b or k.shape[1] != s
            or k.shape[3] != d or k.dtype != q.dtype):
        raise ValueError(f"rope: k {k.dtype} {tuple(k.shape)} does not "
                         f"match q {q.dtype} {tuple(q.shape)}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
            or cos.shape != sin.shape or cos.dim() != 2 or cos.shape[1] != d:
        raise ValueError("rope kernel: cos/sin must be fp32 [rows, d]")
    if pos2d is None:
        if cos.shape[0] != s:
            raise ValueError(f"rope: cos rows {cos.shape[0]} != seq {s}")
    elif pos2d.dtype != torch.int32 or tuple(pos2d.shape) != (b, s):
        raise ValueError(f"rope kernel: positions must be int32 [b, s] = "
                         f"{(b, s)}; got {pos2d.dtype} "
                         f"{tuple(pos2d.shape)}")
    dev = x.device
    for t in (q, k, cos, sin, pos2d):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"rope: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("rope kernel takes contiguous tensors")


@functools.cache
def _entry():
    fn = _build.load("rope").rope_qk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def rope_qk(q, k, cos, sin, pos2d=None, sign=1):
    """(q', k'): rotate-half RoPE of q [b, s, hq, d] and k [b, s, hkv, d]
    (either may be None, and stays None) with fp32 cos/sin [s, d] where
    pos2d is None, else fp32 tables [P, d] at int32 positions pos2d [b, s]
    clamped to [0, P-1]; sign -1 rotates the other way. CUDA tensors
    launch the kernel once for both (counted on `rope` or `rope_packed`),
    CPU tensors take the plain versions."""
    x = q if q is not None else k
    if x is None:
        return None, None
    if x.device.type == "cpu":
        return rope_qk_plain(q, k, cos, sin, pos2d, sign)
    if x.device.type != "cuda":
        raise ValueError(f"rope: no kernel for {x.device}")
    _check(q, k, cos, sin, pos2d)
    b, s, _, d = x.shape
    hq = 0 if q is None else q.shape[2]
    hkv = 0 if k is None else k.shape[2]
    qo = None if q is None else torch.empty_like(q)
    ko = None if k is None else torch.empty_like(k)
    if b * s and hq + hkv:
        status = _entry()(
            _ptr(q), _ptr(k), cos.data_ptr(), sin.data_ptr(), _ptr(pos2d),
            _ptr(qo), _ptr(ko), b * s, s, hq, hkv, d, cos.shape[0],
            _sign(sign), _DTYPES[x.dtype], _build.stream_ptr(x))
        _build.check_status(status, "rope_qk")
        if pos2d is None:
            _counts.count(rope)
        else:
            _counts.count(rope_packed)
    return qo, ko


def rope(x, cos, sin, sign=1):
    """Rotate-half RoPE of x [b, s, h, d] with cos/sin [s, d] (fp32); sign
    -1 rotates the other way. CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    return rope_qk(x, None, cos, sin, None, sign)[0]


def rope_packed(x, cos_tab, sin_tab, pos2d, sign=1):
    """RoPE of x [b, s, h, d] at per-token positions pos2d [b, s] (int32)
    into fp32 tables [P, d], positions clamped to [0, P-1]; sign -1 rotates
    the other way. CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    return rope_qk(x, None, cos_tab, sin_tab, pos2d, sign)[0]


rope.launches = 0
rope_packed.launches = 0


class RopeQKFunction(torch.autograd.Function):
    """rope_qk(q, k, cos, sin, pos2d): one launch for q and k; the gradient
    is one launch with sign -1 on (gq, gk), for the inputs that want one.
    The tables and positions take no gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, pos2d):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(cos, sin, pos2d)
        return rope_qk(q, k, cos, sin, pos2d)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin, pos2d = ctx.saved_tensors
        want_q, want_k = ctx.needs_input_grad[:2]
        gq = gq.contiguous() if want_q and gq is not None else None
        gk = gk.contiguous() if want_k and gk is not None else None
        dq, dk = rope_qk(gq, gk, cos, sin, pos2d, sign=-1)
        return dq, dk, None, None, None


def _fused(q, k, cos, sin, pos2d):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return RopeQKFunction.apply(q, k, cos, sin, pos2d)
    return rope_qk(q, k, cos, sin, pos2d)


def fused_rope(q, k, cos, sin):
    """q [b, s, hq, d], k [b, s, hkv, d]; cos, sin [s, d] fp32 (paddle_tpu
    fused_rope); differentiable in q and k. Where no gradient is wanted
    (serving, under no_grad) the kernel runs with no autograd node."""
    return _fused(q, k, cos, sin, None)


def fused_rope_packed(q, k, cos_tab, sin_tab, pos2d):
    """q, k [b, s, h, d]; fp32 tables [P, d]; int32 pos2d [b, s]
    (paddle_tpu fused_rope_packed); differentiable in q and k, as
    fused_rope is."""
    return _fused(q, k, cos_tab, sin_tab, pos2d)
