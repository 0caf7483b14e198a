"""Flash attention, dense and segmented: the CUDA kernels in
csrc/flash_attention.cu, their plain PyTorch versions and the autograd
Functions that join them.

Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (via `_fwd`),
`_dq_kernel` and `_dkv_kernel` (via `_bwd`), and their segmented siblings
`_fwd_seg_kernel` (via `_seg_fwd`), `_bwd_seg_kernel` and `_dkv_seg_kernel`
(via `_seg_bwd`). The source's header says what bounds the kernels on the
H100 and how their design answers it. The dense plain versions are the
counterparts of the reference's XLA pair `_dense_fwd` / `_dense_bwd`, split
the way the kernels are; the segmented ones compute what the segmented TPU
kernels compute (a masked score adds exactly 0 to P, so a query row with no
live key gives o = 0).

    q                 [b, sq, h, d]
    k, v              [b, sk, h, d]
    o, dq             [b, sq, h, d] in q's dtype; dk, dv [b, sk, h, d]
    lse, delta        [b * h, sq] float32
    seg_q, seg_k      [b, sq], [b, sk] int32 segment ids (padding -1):
                      query i sees key j only where seg_q[i] == seg_k[j]

The causal mask is top-left aligned (query i sees keys j <= i), as the TPU
kernel's is; `supports()` keeps causal attention with sq != sk on the
composition, whose mask is bottom-right aligned.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The reference's block sizes: its gate admits only sequences they divide.
BLOCK_Q = 128
BLOCK_K = 128


def supports(q_shape, k_shape, attn_mask, dropout_p, is_causal=False) -> bool:
    """The reference's shape gate (flash_attention.py `supports`): anything
    else goes to the XLA-style composition. The kernels take every head_dim
    it admits (d <= 256) and any sequence lengths."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    return (attn_mask is None and dropout_p == 0.0
            and sq % BLOCK_Q == 0 and sk % BLOCK_K == 0
            and sq >= BLOCK_Q and sk >= BLOCK_K and d <= MAX_HEAD_DIM
            and not (is_causal and sq != sk))


# ------------------------------------------------------------ plain versions
def _heads_first(x):
    """[b, s, h, d] -> [b * h, s, d] in fp32."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).float()


def _heads_last(x, b, h, dtype):
    """[b * h, s, d] -> [b, s, h, d] in `dtype`."""
    bh, s, d = x.shape
    return x.to(dtype).reshape(b, h, s, d).permute(0, 2, 1, 3).contiguous()


def _scores(q, k, scale, causal):
    """fp32 scores [b*h, sq, sk], masked entries NEG_INF (top-left)."""
    s = torch.bmm(_heads_first(q), _heads_first(k).transpose(1, 2)) * scale
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, scale, causal):
    """(o, lse) as `_dense_fwd` computes them."""
    b, sq, h, d = q.shape
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.bmm(p, _heads_first(v))
    return _heads_last(o, b, h, q.dtype), lse


def _dscores(q, k, v, dout, lse, delta, scale, causal):
    """(P, dS) recomputed from the residuals, fp32 [b*h, sq, sk]."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.bmm(_heads_first(dout), _heads_first(v).transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_dq_plain(q, k, v, dout, lse, delta, scale, causal):
    b, sq, h, d = q.shape
    _, ds = _dscores(q, k, v, dout, lse, delta, scale, causal)
    dq = torch.bmm(ds, _heads_first(k)) * scale
    return _heads_last(dq, b, h, q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, scale, causal):
    b, sk, h, d = k.shape
    p, ds = _dscores(q, k, v, dout, lse, delta, scale, causal)
    dv = torch.bmm(p.transpose(1, 2), _heads_first(dout))
    dk = torch.bmm(ds.transpose(1, 2), _heads_first(q)) * scale
    return _heads_last(dk, b, h, k.dtype), _heads_last(dv, b, h, v.dtype)


def _bhsd(x):
    """[b, s, h, d] -> [b, h, s, d] in fp32."""
    return x.permute(0, 2, 1, 3).float()


def _seg_scores(q, k, seg_q, seg_k, scale, causal):
    """fp32 scores [b, h, sq, sk] with every pair that is not live at
    NEG_INF, and the live mask [b, 1, sq, sk]."""
    live = (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
    if causal:
        sq, sk = seg_q.shape[1], seg_k.shape[1]
        live = live & torch.ones(sq, sk, dtype=torch.bool,
                                 device=live.device).tril()
    s = torch.matmul(_bhsd(q), _bhsd(k).transpose(-1, -2)) * scale
    return s.masked_fill(~live, NEG_INF), live


def flash_seg_fwd_plain(q, k, v, seg_q, seg_k, scale, causal):
    """(o, lse) as `_fwd_seg_kernel` computes them."""
    b, sq, h, _ = q.shape
    s, live = _seg_scores(q, k, seg_q, seg_k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, _bhsd(v)) / den
    return (_heads_last(o.flatten(0, 1), b, h, q.dtype),
            (m + torch.log(den)).reshape(b * h, sq))


def _seg_dscores(q, k, v, seg_q, seg_k, dout, lse, delta, scale, causal):
    """(P, dS) [b, h, sq, sk] recomputed from the residuals."""
    b, sq, h, _ = q.shape
    s, live = _seg_scores(q, k, seg_q, seg_k, scale, causal)
    p = torch.where(live, torch.exp(s - lse.reshape(b, h, sq, 1)), 0.0)
    dp = torch.matmul(_bhsd(dout), _bhsd(v).transpose(-1, -2))
    return p, p * (dp - delta.reshape(b, h, sq, 1))


def flash_seg_dq_plain(q, k, v, seg_q, seg_k, dout, lse, delta, scale,
                       causal):
    b, _, h, _ = q.shape
    _, ds = _seg_dscores(q, k, v, seg_q, seg_k, dout, lse, delta, scale,
                         causal)
    dq = torch.matmul(ds, _bhsd(k)) * scale
    return _heads_last(dq.flatten(0, 1), b, h, q.dtype)


def flash_seg_dkv_plain(q, k, v, seg_q, seg_k, dout, lse, delta, scale,
                        causal):
    b, _, h, _ = k.shape
    p, ds = _seg_dscores(q, k, v, seg_q, seg_k, dout, lse, delta, scale,
                         causal)
    dv = torch.matmul(p.transpose(-1, -2), _bhsd(dout))
    dk = torch.matmul(ds.transpose(-1, -2), _bhsd(q)) * scale
    return (_heads_last(dk.flatten(0, 1), b, h, k.dtype),
            _heads_last(dv.flatten(0, 1), b, h, v.dtype))


# ------------------------------------------------------------------ kernels
@functools.cache
def _entries():
    """(fwd, dq, dkv) C entry points; null segment-id pointers select the
    dense kernels."""
    lib = _build.load("flash_attention")
    ints = [ctypes.c_int] * 5
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fns = (lib.flash_attention_fwd, lib.flash_attention_dq,
           lib.flash_attention_dkv)
    for fn, pointers in zip(fns, (7, 9, 10)):
        fn.argtypes = [ctypes.c_void_p] * pointers + ints + tail
        fn.restype = ctypes.c_int
    return fns


def _check(q, k, v, *more):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q [b, sq, h, d] and k, v "
                         f"[b, sk, h, d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError("flash attention: q and k/v disagree on b, h or d")
    if not 1 <= d <= MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"flash attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and b*h <= 65535; got d={d}, "
                         f"b*h={b * h}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for t in (q, k, v) + more:
        if t.device != q.device:
            raise ValueError("flash attention: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("flash attention kernel takes contiguous "
                             "tensors")


def _check_rows(q, *rows):
    b, sq, h, _ = q.shape
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (b * h, sq):
            raise ValueError(f"flash attention: lse/delta must be float32 "
                             f"[{b * h}, {sq}]; got {t.dtype} "
                             f"{tuple(t.shape)}")


def _geometry(q, k, scale, causal):
    b, sq, h, d = q.shape
    return (b, h, sq, k.shape[1], d, float(scale), int(bool(causal)),
            _DTYPES[q.dtype], _build.stream_ptr(q))


def _on_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")


def _check_seg(q, k, seg_q, seg_k):
    b, sq = q.shape[:2]
    sk = k.shape[1]
    for t, s in ((seg_q, sq), (seg_k, sk)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b, s):
            raise ValueError(f"segmented flash attention: segment ids must "
                             f"be int32 [{b}, {s}]; got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("segmented flash attention: segment ids must "
                             "be contiguous, on q's device")


def _check_dout(name, q, dout):
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout must match q")


def _ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _run_fwd(wrapper, q, k, v, seg_q, seg_k, scale, causal):
    """Launch the forward kernel (segmented where seg_q is given), counted
    on `wrapper`."""
    _check(q, k, v)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    status = _entries()[0](*_ptrs(q, k, v, seg_q, seg_k, o, lse),
                           *_geometry(q, k, scale, causal))
    _build.check_status(status, wrapper.__name__)
    wrapper.launches += 1
    return o, lse


def _run_bwd(wrapper, outs, q, k, v, seg_q, seg_k, dout, lse, delta, scale,
             causal):
    """Launch dQ (outs = (dq,)) or dK/dV (outs = (dk, dv)) into `outs`
    (segmented where seg_q is given), counted on `wrapper`."""
    _check(q, k, v, dout, lse, delta)
    _check_rows(q, lse, delta)
    _check_dout(wrapper.__name__, q, dout)
    status = _entries()[len(outs)](
        *_ptrs(q, k, v, seg_q, seg_k, dout, lse, delta, *outs),
        *_geometry(q, k, scale, causal))
    _build.check_status(status, wrapper.__name__)
    wrapper.launches += 1
    return outs


def flash_fwd(q, k, v, scale, causal):
    """(o, lse). CUDA tensors launch the forward kernel, CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal)
    _on_cuda("flash_fwd", q)
    return _run_fwd(flash_fwd, q, k, v, None, None, scale, causal)


def flash_dq(q, k, v, dout, lse, delta, scale, causal):
    """dq. CUDA tensors launch the dQ kernel, CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, scale, causal)
    _on_cuda("flash_dq", q)
    return _run_bwd(flash_dq, (torch.empty_like(q),), q, k, v, None, None,
                    dout, lse, delta, scale, causal)[0]


def flash_dkv(q, k, v, dout, lse, delta, scale, causal):
    """(dk, dv). CUDA tensors launch the dK/dV kernel, CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, scale, causal)
    _on_cuda("flash_dkv", q)
    return _run_bwd(flash_dkv, (torch.empty_like(k), torch.empty_like(v)),
                    q, k, v, None, None, dout, lse, delta, scale, causal)


def flash_seg_fwd(q, k, v, seg_q, seg_k, scale, causal):
    """(o, lse) with segment ids. CUDA tensors launch the segmented forward
    kernel, CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_seg_fwd_plain(q, k, v, seg_q, seg_k, scale, causal)
    _on_cuda("flash_seg_fwd", q)
    _check_seg(q, k, seg_q, seg_k)
    return _run_fwd(flash_seg_fwd, q, k, v, seg_q, seg_k, scale, causal)


def flash_seg_dq(q, k, v, seg_q, seg_k, dout, lse, delta, scale, causal):
    """dq with segment ids. CUDA tensors launch the segmented dQ kernel, CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_seg_dq_plain(q, k, v, seg_q, seg_k, dout, lse, delta,
                                  scale, causal)
    _on_cuda("flash_seg_dq", q)
    _check_seg(q, k, seg_q, seg_k)
    return _run_bwd(flash_seg_dq, (torch.empty_like(q),), q, k, v, seg_q,
                    seg_k, dout, lse, delta, scale, causal)[0]


def flash_seg_dkv(q, k, v, seg_q, seg_k, dout, lse, delta, scale, causal):
    """(dk, dv) with segment ids. CUDA tensors launch the segmented dK/dV
    kernel, CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_seg_dkv_plain(q, k, v, seg_q, seg_k, dout, lse, delta,
                                   scale, causal)
    _on_cuda("flash_seg_dkv", q)
    _check_seg(q, k, seg_q, seg_k)
    return _run_bwd(flash_seg_dkv, (torch.empty_like(k), torch.empty_like(v)),
                    q, k, v, seg_q, seg_k, dout, lse, delta, scale, causal)


flash_fwd.launches = flash_dq.launches = flash_dkv.launches = 0
flash_seg_fwd.launches = flash_seg_dq.launches = flash_seg_dkv.launches = 0


def attention_delta(o, dout):
    """delta = rowsum(dO * O) in fp32, [b * h, sq] (the reference computes
    it in XLA before its backward kernels)."""
    b, sq, h, _ = o.shape
    d = (dout.float() * o.float()).sum(-1)
    return d.permute(0, 2, 1).reshape(b * h, sq).contiguous()


class FlashAttention(torch.autograd.Function):
    """Forward launches the forward kernel and saves (q, k, v, o, lse);
    backward launches dQ and dK/dV (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = attention_delta(o, dout)
        dq = flash_dq(q, k, v, dout, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale=None, causal=False):
    """Flash attention on [b, s, h, d]; differentiable."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, float(scale), bool(causal))


class FlashSegmentedAttention(torch.autograd.Function):
    """The segmented kernels joined as FlashAttention joins the dense ones
    (the reference's `flash_attention_segmented` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_seg_fwd(q, k, v, seg_q, seg_k, scale, causal)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = attention_delta(o, dout)
        args = (q, k, v, seg_q, seg_k, dout, lse, delta, ctx.scale,
                ctx.causal)
        dq = flash_seg_dq(*args)
        dk, dv = flash_seg_dkv(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention_segmented(q, k, v, segment_ids, scale=None,
                              causal=False):
    """Attention on [b, s, h, d] restricted to equal segment ids [b, s]
    (padding -1, which matches only itself); differentiable in q, k, v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    return FlashSegmentedAttention.apply(q, k, v, seg, seg, float(scale),
                                         bool(causal))
