"""RMSNorm forward and backward: Triton kernels, their plain PyTorch versions
and the autograd Function that joins them.

Replaces paddle_tpu/ops/pallas/fused_norm.py `_fwd_kernel` (via `_run_fwd`)
and `_bwd_kernel` (via `_bwd_rule`). The versions compute what those kernels
compute. Forward: statistics in fp32, y = (x * rstd * w) in fp32, cast to
x's dtype once at the end, and the fp32 rstd [n, 1] of each row kept for the
backward. (The reference's XLA fallback, nn_ops.rms_norm:227-231, casts
before the weight multiply; in bf16 that differs from the kernel by one
rounding, and the port follows the kernel.) Backward, with x^ = x * rstd:

    dx = rstd * (g*w - x^ * mean(g*w * x^))     in x's dtype
    dw = sum over rows of g * x^                 fp32, cast to w's dtype

What bounds them on the H100: bytes. The forward reads each row once and
writes it once with ~4 flops per element; the backward reads x and g and
writes dx, ~10 flops per element. One forward program owns one whole row (d
= 4096 fits a block of registers), so the row is read from device memory
once for both passes (sum of squares, then scale), the counterpart of the
TPU kernel keeping its row block in VMEM. The weight row stays in L2 across
programs.

The TPU backward carries dw across its sequential grid in one output block.
Hopper's blocks run in parallel, so here each backward program owns ROWS
consecutive rows, writes their dx and one fp32 partial row of dw into a
[programs, d] scratch, and a second kernel sums that scratch column by
column in a fixed order: dw is the same bit for bit from run to run (no
float atomics). The scratch is 1/ROWS of the row data, a few percent of the
bytes. The TPU kernels' row padding has no counterpart: rows past n are
masked.
"""
import functools

import torch

from . import _build

# Bound by _triton_kernel on first launch: the jitted body looks its names up
# in this module's globals, and importing triton at module import would
# break CPU-only installs.
triton = tl = None
ROWS = 16          # rows per backward program
DW_COLS = 128      # columns per program of the dw reduction
DW_ROWS = 64       # partial rows summed per iteration of the reduction


def rms_norm_fwd_plain(x, weight, eps):
    """(y, rstd): y in x's dtype, rstd [n, 1] float32 over n = rows of x."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    y = (xf * rstd * weight.float()).to(x.dtype)
    return y, rstd.reshape(-1, 1)


def rms_norm_plain(x, weight, eps):
    return rms_norm_fwd_plain(x, weight, eps)[0]


def rms_norm_bwd_plain(x, weight, rstd, g):
    """(dx in x's dtype, dw in weight's dtype) from the saved fp32 rstd."""
    d = x.shape[-1]
    xhat = x.reshape(-1, d).float() * rstd
    gf = g.reshape(-1, d).float()
    gw = gf * weight.float()
    c = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gw - xhat * c)).to(x.dtype).reshape(x.shape)
    return dx, (gf * xhat).sum(dim=0).to(weight.dtype)


@functools.cache
def _triton_kernels():
    global triton, tl
    triton, tl = _build.import_triton()

    @triton.jit
    def _rms_fwd(x_ptr, w_ptr, y_ptr, rstd_ptr, d, eps,
                 STORE_RSTD: tl.constexpr, BLOCK_D: tl.constexpr):
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
        if STORE_RSTD:
            tl.store(rstd_ptr + row, rstd)

    @triton.jit
    def _rms_bwd(x_ptr, w_ptr, rstd_ptr, g_ptr, dx_ptr, part_ptr, n, d,
                 ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK_D], dtype=tl.float32)
        for r in range(ROWS):
            row = pid * ROWS + r
            live = row < n
            mask = cmask & live
            x = tl.load(x_ptr + row * d + cols, mask=mask,
                        other=0.0).to(tl.float32)
            g = tl.load(g_ptr + row * d + cols, mask=mask,
                        other=0.0).to(tl.float32)
            rstd = tl.load(rstd_ptr + row, mask=live, other=0.0)
            xhat = x * rstd
            gw = g * w
            c = tl.sum(gw * xhat, axis=0) / d
            dx = rstd * (gw - xhat * c)
            tl.store(dx_ptr + row * d + cols,
                     dx.to(dx_ptr.dtype.element_ty), mask=mask)
            acc += g * xhat
        tl.store(part_ptr + pid * d + cols, acc, mask=cmask)

    @triton.jit
    def _rms_dw(part_ptr, dw_ptr, parts, d, BLOCK_C: tl.constexpr,
                BLOCK_R: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < d
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for r0 in range(0, parts, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows[:, None] < parts) & cmask[None, :]
            blk = tl.load(part_ptr + rows[:, None].to(tl.int64) * d
                          + cols[None, :], mask=mask, other=0.0)
            acc += tl.sum(blk, axis=0)
        tl.store(dw_ptr + cols, acc.to(dw_ptr.dtype.element_ty), mask=cmask)

    return _rms_fwd, _rms_bwd, _rms_dw


def _check(x, weight, *more):
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rms_norm kernel: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} on "
                         f"{weight.device} does not match x [..., {d}] on "
                         f"{x.device}")
    for t in (x, weight) + more:
        if t.device != x.device:
            raise ValueError("rms_norm: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("rms_norm kernel takes contiguous tensors")


def _num_warps(block):
    return min(16, max(1, block // 256))


def rms_norm_fwd(x, weight, eps, with_rstd=True):
    """(y, rstd [n, 1] fp32; None without `with_rstd`, which the kernel
    then does not store). CUDA tensors launch the forward kernel (counted on
    `fused_rms_norm`), CPU tensors take the plain version."""
    if x.device.type == "cpu":
        y, rstd = rms_norm_fwd_plain(x, weight, eps)
        return y, rstd if with_rstd else None
    if x.device.type != "cuda":
        raise ValueError(f"fused_rms_norm: no kernel for {x.device}")
    _check(x, weight)
    fwd, _, _ = _triton_kernels()
    d = x.shape[-1]
    n = x.numel() // d
    y = torch.empty_like(x)
    rstd = (torch.empty(n, 1, dtype=torch.float32, device=x.device)
            if with_rstd else None)
    if n:
        block = triton.next_power_of_2(d)
        fwd[(n,)](x, weight, y, y if rstd is None else rstd, d, float(eps),
                  STORE_RSTD=with_rstd, BLOCK_D=block,
                  num_warps=_num_warps(block))
        fused_rms_norm.launches += 1
    return y, rstd


def fused_rms_norm_bwd(x, weight, rstd, g):
    """(dx, dw) of RMSNorm from the forward's input, weight and fp32 rstd
    and the output's gradient g. CUDA tensors launch the backward kernel
    and its dw reduction, CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, rstd, g)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rms_norm_bwd: no kernel for {x.device}")
    _check(x, weight, rstd, g)
    d = x.shape[-1]
    n = x.numel() // d
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"fused_rms_norm_bwd: g {g.dtype} "
                         f"{tuple(g.shape)} must match x {x.dtype} "
                         f"{tuple(x.shape)}")
    if rstd.dtype != torch.float32 or rstd.numel() != n:
        raise ValueError(f"fused_rms_norm_bwd: rstd must be float32 with "
                         f"{n} rows")
    _, bwd, reduce = _triton_kernels()
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    if n:
        parts = triton.cdiv(n, ROWS)
        partial = torch.empty(parts, d, dtype=torch.float32,
                              device=x.device)
        block = triton.next_power_of_2(d)
        bwd[(parts,)](x, weight, rstd, g, dx, partial, n, d, ROWS=ROWS,
                      BLOCK_D=block, num_warps=_num_warps(block))
        reduce[(triton.cdiv(d, DW_COLS),)](partial, dw, parts, d,
                                           BLOCK_C=DW_COLS, BLOCK_R=DW_ROWS,
                                           num_warps=4)
        fused_rms_norm_bwd.launches += 1
    else:
        dw.zero_()
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """Forward launches the forward kernel and saves (x, weight, rstd);
    backward launches the backward kernel (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        x = x.contiguous()
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = fused_rms_norm_bwd(x, weight, rstd,
                                    g.to(x.dtype).contiguous())
        return dx, dw, None


def fused_rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last axis; weight [d]; differentiable in x and
    weight. CUDA tensors launch the Triton kernels, CPU tensors take the
    plain versions. Where no gradient is wanted (serving, under no_grad)
    the forward kernel runs alone: no autograd node, no rstd stored."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFunction.apply(x, weight, float(eps))
    return rms_norm_fwd(x.contiguous(), weight, float(eps),
                        with_rstd=False)[0]


fused_rms_norm.launches = 0
fused_rms_norm_bwd.launches = 0
