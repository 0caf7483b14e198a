#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving and training paths (GPT, and Llama on
packed documents) on one H100 and hold each of its hand-written kernels
against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
final line):

  1. device  - the card's name and power limit (nvidia-smi); capability 9.0
  2. build   - nvcc builds every CUDA source under paddle_tpu_torch/csrc/,
               one process per source, all at once
  3. kernels - each kernel against its plain version on the card, in bf16
               and fp32, at its path's shapes: max |error| within the stated
               tolerance, and median time (CUDA events) beside the plain
               version's, one PyTorch library call's where one computes the
               same function (a yardstick only; the port never calls it),
               and the bound: the larger of bytes moved / 3.35 TB/s and
               operations / the peak rate of the input type. Paged decode
               runs at the main path's shapes with the split count the
               wrapper chooses there and with one split; flash attention at
               GPT-3 1.3B's (b 4, s 2048, h 16, d 128, causal), at d 64 and
               non-causal with sq != sk; segmented flash at the packed
               slice's (b 2, s 4096, h 32, d 128, causal, its segment
               layout; bf16) and a small fp32 case (d 64, s 300,
               non-causal, a -1 padding tail, rows with no live key, whose
               o must be exactly 0); the RMSNorm backward at [8192, 4096];
               RoPE with sign -1 (the backward) at [2, 4096, 32, 128],
               contiguous and at the slice's per-document positions;
               AdamW over GPT-3 1.3B's flat size and a ragged small one
  4. parity  - Llama at full width, 2 layers, fp32 (TF32 off), seeded
               weights: ServingEngine.generate must equal model.generate token
               for token, greedy
  5. slice   - main path 1: Llama-2-7B at full depth in bf16 served by
               ServingEngine (8 slots, 16-token blocks, 2048 context) over 10
               requests (prompts 16-1024 tokens, two sharing a 256-token
               prefix, one repeated for a copy-on-write hit), 64 new tokens
               each; every serving kernel's launch count over this phase
               must be > 0
  6. train_parity - GPT at GPT-3 1.3B's width, 2 layers, fp32 (TF32 off):
               three TrainSteps (AdamW, global-norm clip) on the card and the
               same three on the CPU (plain versions) from the same weights
               and batch; losses and parameters must agree (bounds below)
  7. train_slice - main path 2: GPT-3 1.3B at full depth, amp O1 (bf16),
               AdamW, batch 4 x 2048 through TrainStep: one warm-up step and
               three timed steps on one repeated batch; loss, step time,
               tokens/s, peak memory and launches per step; every training
               kernel's launch count over this phase must be > 0
  8. train_parity (packed Llama) - Llama-2-7B's width, 2 layers, fp32, one
               packed row of 256 tokens (four documents and a padding tail):
               three TrainSteps on the card and on the CPU, as in 6
  9. train_packed_slice - main path 3: Llama-2-7B at its published widths
               cut to 8 layers, amp O1, AdamW, one packed batch of 2 x 4096
               tokens from PackedLMBatches: one warm-up step and three
               timed steps; loss, step time, tokens/s (all and non-padding),
               peak memory and launches per step, which must be the
               expected counts (segmented flash 8 each, RMSNorm and its
               backward 17, per-token RoPE 32, AdamW 1, dense flash 0)

The last two lines are the kernel summary {"kernels": [...]} and
{"ok": true, "device": {...}}. Exits non-zero without them when no CUDA
device is present or the package is not beside this script.
"""
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(fn, iters=20, reps=5):
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes, nops, dtype):
    """(least time in ms, what bounds it) for this work on an H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / PEAK_OPS_PER_S[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ kernel cases
def _tol(dtype):
    import torch

    # Both sides do the same fp32 arithmetic in another order (max |error|
    # measured at most 1.2e-6 in fp32); in bf16 both then round that fp32
    # value once, so they may differ by one bf16 ulp, at most 2**-7 of the
    # value. The fp32 slack stays as the absolute term in both dtypes.
    return (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2.0 ** -7)


def _compare(name, shape, dtype, got, want, tol=None):
    """Max |got - want| over a tensor or a tuple of tensors. Without `tol`
    the bound is _tol(dtype)'s atol + rtol |want|; with tol = {dtype: (rtol,
    rms)} it is rtol |want| + rms * RMS(want), float32 outputs (lse)
    taking the float32 entry."""
    import torch

    if isinstance(got, (tuple, list)):
        return max(_compare(name, shape, dtype, g, w, tol)
                   for g, w in zip(got, want))
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if tol is None:
        atol, rtol = _tol(dtype)
        limit = atol + rtol * w.abs()
        said = f"atol {atol}, rtol {rtol:.3g}"
    else:
        rtol, rms = tol[got.dtype]
        limit = rtol * w.abs() + rms * w.square().mean().sqrt()
        said = f"rtol {rtol:.3g}, {rms:.3g} x RMS"
    ok = bool(torch.isfinite(g).all()) and bool((err <= limit).all())
    if not ok:
        raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees with "
                             f"the plain version (max abs err "
                             f"{err.max().item():.3g}, {said})")
    return float(err.max())


def rms_case(torch, gen, dtype, n, d=4096):
    from paddle_tpu_torch.ops.gpu import fused_norm

    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    es = x.element_size()
    return dict(
        name="rms_norm", shape=[n, d],
        kernel=lambda: fused_norm.fused_rms_norm(x, w, eps),
        plain=lambda: fused_norm.rms_norm_plain(x, w, eps),
        library=lambda: torch.nn.functional.rms_norm(x, (d,), w, eps),
        nbytes=2 * n * d * es + d * es, nops=4 * n * d)


def rms_fwd_case(torch, gen, dtype, n, d=4096):
    """The forward as training runs it: both outputs of rms_norm_fwd, y and
    the fp32 rstd [n, 1] that the backward reads. fp32 y and rstd: the same
    fp32 arithmetic in another order, 1e-5 of the value and of the RMS; bf16
    y: one bf16 rounding (2**-7) of the value, plus the fp32 slack."""
    from paddle_tpu_torch.ops.gpu import fused_norm

    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    es = x.element_size()
    return dict(
        name="rms_norm", shape=[n, d, "y and rstd"],
        tol={torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)},
        kernel=lambda: fused_norm.rms_norm_fwd(x, w, eps),
        plain=lambda: fused_norm.rms_norm_fwd_plain(x, w, eps),
        library=lambda: torch.nn.functional.rms_norm(x, (d,), w, eps),
        nbytes=2 * n * d * es + d * es + n * 4, nops=4 * n * d)


def _sign_shape(shape, sign):
    return shape if sign == 1 else shape + ["sign -1 (backward)"]


def rope_case(torch, gen, dtype, s, h=32, d=128, start=512, b=1, sign=1):
    from paddle_tpu_torch.ops.gpu import rope

    x = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    cos_t, sin_t = _tables(torch, start + s, d)
    cos, sin = cos_t[start:start + s].contiguous(), \
        sin_t[start:start + s].contiguous()
    return dict(
        name="rope", shape=_sign_shape([b, s, h, d], sign),
        kernel=lambda: rope.rope(x, cos, sin, sign),
        plain=lambda: rope.rope_plain(x, cos, sin, sign), library=None,
        nbytes=2 * x.numel() * x.element_size() + 2 * s * d * 4,
        nops=3 * x.numel())


def rope_packed_case(torch, gen, dtype, b, s, h=32, d=128, P=4096,
                     pos=None, sign=1):
    """pos=None: ragged serving offsets; else the given positions [b, s]."""
    from paddle_tpu_torch.ops.gpu import rope

    x = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    cos_t, sin_t = _tables(torch, P, d)
    if pos is None:
        # ragged offsets, some rows running past the table's last position
        base = torch.randint(0, P + 64 - s, (b,), device="cuda",
                             generator=gen)
        pos = (base[:, None] + torch.arange(s, device="cuda")[None]).to(
            torch.int32).contiguous()
    rows = int(torch.unique(pos.clamp(0, P - 1)).numel())
    return dict(
        name="rope_packed", shape=_sign_shape([b, s, h, d], sign),
        kernel=lambda: rope.rope_packed(x, cos_t, sin_t, pos, sign),
        plain=lambda: rope.rope_packed_plain(x, cos_t, sin_t, pos, sign),
        library=None,
        nbytes=(2 * x.numel() * x.element_size() + pos.numel() * 4
                + 2 * rows * d * 4),
        nops=3 * x.numel())


def paged_case(torch, gen, dtype, slots, hq, hkv, d, bs, ctx_lens,
               splits=None):
    """splits=None leaves the split count to the wrapper, as the serving
    path does (the printed shape then holds the count it chooses)."""
    from paddle_tpu_torch.ops.gpu import paged_attention as pa

    max_ctx = max(ctx_lens)
    maxb = -(-max_ctx // bs)
    shown = splits if splits is not None else pa.choose_kv_splits(
        slots, hkv, maxb, bs,
        torch.cuda.get_device_properties(0).multi_processor_count)
    nb = slots * maxb + 1
    kp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    q = torch.randn(slots, hq, d, device="cuda", generator=gen).to(dtype)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    bt = perm[:slots * maxb].reshape(slots, maxb).to(torch.int32)
    cl = torch.tensor(ctx_lens, dtype=torch.int32, device="cuda")
    for r, c in enumerate(ctx_lens):      # null pages past each context
        bt[r, -(-c // bs):] = 0
    bt = bt.contiguous()
    scale = d ** -0.5
    # yardstick: one SDPA call over K/V already gathered (gather not timed)
    kg = kp[bt.long()].reshape(slots, maxb * bs, hkv, d)
    vg = vp[bt.long()].reshape(slots, maxb * bs, hkv, d)
    kg = kg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(maxb * bs, device="cuda")[None, :]
            < cl[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    es = q.element_size()
    live = sum(ctx_lens)
    return dict(
        name="paged_decode",
        shape=[slots, hq, hkv, d, bs, max_ctx, shown],
        kernel=lambda: pa.paged_attention(q, kp, vp, bt, cl, scale, splits),
        plain=lambda: pa.paged_attention_plain(q, kp, vp, bt, cl, scale),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale),
        nbytes=(2 * live * hkv * d * es + 2 * q.numel() * es
                + sum(-(-c // bs) for c in ctx_lens) * 4 + slots * 4),
        nops=4 * live * hq * d)


# Flash attention: both sides compute in fp32 from the same inputs. fp32
# sums over up to s = 2048 products in another order (and the forward's
# online softmax rescales as it goes), so outputs differ by up to ~1e-4 of
# their RMS (measured 1.6e-4 for dK at the main shape): fp32 bound 1e-5 of
# the value + 1e-3 of the RMS. bf16: one bf16 rounding (2**-7) of the value
# and of the RMS, as in tests/test_torch_flash.py.
def _flash_tol(torch):
    return {torch.float32: (1e-5, 1e-3), torch.bfloat16: (2.0 ** -7,
                                                          2.0 ** -7)}


def flash_cases(torch, gen, dtype, b, sq, sk, h, d, causal):
    """Three cases (forward, dQ, dK/dV) on one set of inputs."""
    from paddle_tpu_torch.ops.gpu import flash_attention as fa

    def rnd(s):
        return torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)

    q, k, v, do = rnd(sq), rnd(sk), rnd(sk), rnd(sq)
    scale = d ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    delta = fa.attention_delta(o, do)
    # yardsticks: SDPA in its [b, h, s, d] layout, forward and backward
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qt.requires_grad_(True)
    kt.requires_grad_(True)
    vt.requires_grad_(True)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)

    out_t = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                   retain_graph=True)

    pairs = sq * (sq + 1) // 2 if causal else sq * sk   # unmasked (q, k)
    es = q.element_size()
    tensor = b * h * d * es
    rows = b * h * sq * 4                   # one fp32 lse / delta row
    shape = [b, sq, sk, h, d, "causal" if causal else "full"]
    ops = b * h * d * pairs
    tol = _flash_tol(torch)
    args = (q, k, v, do, lse, delta, scale, causal)
    return [
        dict(name="flash_fwd", shape=shape, tol=tol,
             kernel=lambda: fa.flash_fwd(q, k, v, scale, causal),
             plain=lambda: fa.flash_fwd_plain(q, k, v, scale, causal),
             library=lambda: sdpa().detach(),
             nbytes=tensor * (2 * sq + 2 * sk) + rows, nops=4 * ops),
        dict(name="flash_dq", shape=shape, tol=tol,
             kernel=lambda: fa.flash_dq(*args),
             plain=lambda: fa.flash_dq_plain(*args), library=sdpa_bwd,
             nbytes=tensor * (3 * sq + 2 * sk) + 2 * rows, nops=6 * ops),
        dict(name="flash_dkv", shape=shape, tol=tol,
             kernel=lambda: fa.flash_dkv(*args),
             plain=lambda: fa.flash_dkv_plain(*args), library=sdpa_bwd,
             nbytes=tensor * (2 * sq + 4 * sk) + 2 * rows, nops=8 * ops),
    ]


def live_pairs(torch, seg_q, seg_k, causal):
    """(q, k) pairs of this data that the segmented kernels must compute:
    equal segment ids (and k <= q when causal), summed over the batch: for
    packed rows, the sum over documents of L (L + 1) / 2 when causal."""
    live = seg_q[:, :, None] == seg_k[:, None, :]
    if causal:
        live &= torch.ones(live.shape[1:], dtype=torch.bool,
                           device=live.device).tril()
    return int(live.sum())


def seg_flash_cases(torch, gen, dtype, seg_q, h, d, causal, seg_k=None,
                    library=True):
    """Segmented forward, dQ and dK/dV on one set of inputs: q, k, v
    [b, s, h, d] with segment ids seg_q (and seg_k, default seg_q) [b, s].
    Yardsticks: SDPA with the boolean block-diagonal mask (causal folded in),
    forward and backward through autograd; only where every query row has a
    live key (SDPA gives NaN for a row with none)."""
    from paddle_tpu_torch.ops.gpu import flash_attention as fa

    seg_k = seg_q if seg_k is None else seg_k
    b, s = seg_q.shape

    def rnd():
        return torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    scale = d ** -0.5
    o, lse = fa.flash_seg_fwd_plain(q, k, v, seg_q, seg_k, scale, causal)
    delta = fa.attention_delta(o, do)
    pairs = live_pairs(torch, seg_q, seg_k, causal)
    lib_fwd = lib_bwd = None
    if library:
        mask = (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
        if causal:
            mask = mask & torch.ones(s, s, dtype=torch.bool,
                                     device="cuda").tril()
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        for t in (qt, kt, vt):
            t.requires_grad_(True)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale)

        out_t = sdpa()

        def lib_fwd():
            return sdpa().detach()

        def lib_bwd():
            return torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                       retain_graph=True)

    es = q.element_size()
    tensor = b * s * h * d * es             # one [b, s, h, d] tensor
    rows = b * h * s * 4                    # one fp32 lse / delta row
    ids = 2 * b * s * 4                     # seg_q and seg_k
    ops = h * d * pairs
    nsegs = int(sum(torch.unique(r).numel() for r in seg_q))
    shape = [b, s, h, d, "causal" if causal else "full",
             f"{nsegs} segments, {pairs} live pairs"]
    # fp32 (the small case, sums over documents of at most 200 keys): 1e-4
    # of the RMS, not the dense cases' 1e-3, which a product rounded to TF32
    # or a dropped rescale term would pass; measured at most 4.8e-7
    tol = {**_flash_tol(torch), torch.float32: (1e-5, 1e-4)}
    args = (q, k, v, seg_q, seg_k, do, lse, delta, scale, causal)
    return [
        dict(name="flash_seg_fwd", shape=shape, tol=tol,
             kernel=lambda: fa.flash_seg_fwd(q, k, v, seg_q, seg_k, scale,
                                             causal),
             plain=lambda: fa.flash_seg_fwd_plain(q, k, v, seg_q, seg_k,
                                                  scale, causal),
             library=lib_fwd, nbytes=4 * tensor + rows + ids, nops=4 * ops),
        dict(name="flash_seg_dq", shape=shape, tol=tol,
             kernel=lambda: fa.flash_seg_dq(*args),
             plain=lambda: fa.flash_seg_dq_plain(*args), library=lib_bwd,
             nbytes=5 * tensor + 2 * rows + ids, nops=6 * ops),
        dict(name="flash_seg_dkv", shape=shape, tol=tol,
             kernel=lambda: fa.flash_seg_dkv(*args),
             plain=lambda: fa.flash_seg_dkv_plain(*args), library=lib_bwd,
             nbytes=6 * tensor + 2 * rows + ids, nops=8 * ops),
    ]


def no_live_key_check(torch, gen):
    """A small non-causal fp32 case at d 64 with ragged tiles (s 300), a -1
    padding tail, and query rows whose segment id no key carries: their o
    must be exactly 0 from the kernel (and the plain version), and their dq
    too. Returns the three cases for run_case."""
    from paddle_tpu_torch.ops.gpu import flash_attention as fa

    b, s = 2, 300
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    seg[0, 90:200] = 1
    seg[0, 200:] = 2
    seg[1, 150:260] = 1
    seg[1, 260:] = -1                       # padding tail
    seg_q = seg.clone()
    seg_q[0, 5] = seg_q[1, 299] = 7         # no key carries id 7
    cases = seg_flash_cases(torch, gen, torch.float32, seg_q.contiguous(),
                            4, 64, False, seg_k=seg, library=False)
    fwd, dq = cases[0], cases[1]
    dead = seg_q != seg                     # the rows with no live key
    for name, fn in (("kernel", fwd["kernel"]), ("plain", fwd["plain"])):
        o, _ = fn()
        torch.cuda.synchronize()
        if not bool((o[dead] == 0).all()):
            raise AssertionError(f"segmented forward ({name}): a query row "
                                 f"with no live key must give o = 0 "
                                 f"exactly; max |o| {o[dead].abs().max()}")
    if not bool((dq["kernel"]()[dead] == 0).all()):
        raise AssertionError("segmented dQ: a row with no live key must "
                             "give dq = 0 exactly")
    rows = dead.repeat_interleave(4, dim=0).reshape(-1, s)   # [b * h, s]

    def check():
        # the dead rows' lse is the mask value (-1e30 + log 1e-30) on both
        # sides; it is left out so the RMS term stays on the live rows'
        (o, lse), (o_p, lse_p) = fwd["kernel"](), fwd["plain"]()
        return ((o, lse.masked_fill(rows, 0.0)),
                (o_p, lse_p.masked_fill(rows, 0.0)))

    fwd["check"] = check
    return cases


def rms_bwd_case(torch, gen, dtype, n, d=4096):
    """RMSNorm backward from the forward's saved fp32 rstd: the kernel side
    reads the forward kernel's rstd, as the training path does, the plain
    side the plain forward's. Yardstick: the backward of F.rms_norm through
    autograd (dx and dw)."""
    from paddle_tpu_torch.ops.gpu import fused_norm

    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    g = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    eps = 1e-5
    _, rstd = fused_norm.rms_norm_fwd_plain(x, w, eps)
    _, rstd_k = fused_norm.rms_norm_fwd(x, w, eps)
    xt = x.clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    out = torch.nn.functional.rms_norm(xt, (d,), wt, eps)
    es = x.element_size()
    # dx: rstd * (g w - x^ mean(g w x^)); dw: column sums of g x^. fp32:
    # sums of 4096 (dx) and 8192 (dw) products in another order, so 1e-5 of
    # the value plus 1e-5 of the RMS (|dw| grows as sqrt(n)); bf16: one
    # rounding of each (2**-7) of the value and of the RMS.
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7,
                                                         2.0 ** -7)}
    return dict(
        name="rms_norm_bwd", shape=[n, d], tol=tol,
        kernel=lambda: fused_norm.fused_rms_norm_bwd(x, w, rstd_k, g),
        plain=lambda: fused_norm.rms_norm_bwd_plain(x, w, rstd, g),
        library=lambda: torch.autograd.grad(out, (xt, wt), g,
                                            retain_graph=True),
        nbytes=3 * n * d * es + 2 * d * es + n * 4, nops=9 * n * d)


def gpt_numel(cfg):
    """Parameters of a GPTForCausalLM (tied head) from its config."""
    H, inter = cfg.hidden_size, cfg.intermediate_size
    per_layer = (4 * H + 3 * H * H + 3 * H + H * H + H + H * inter + inter
                 + inter * H + H)
    return ((cfg.vocab_size + cfg.max_position_embeddings) * H
            + cfg.num_layers * per_layer + 2 * H)


def adamw_case(torch, gen, n):
    """AdamW over one flat fp32 group of n elements at step 3 with a
    device-scalar gradient scale (the clip's). The kernel updates clones,
    the plain version the originals, both in place; then each is timed in
    place again. Both do the same fp32 operations on the same scalars: 1e-6
    of the value + 1e-6 of the RMS (an FMA here and there)."""
    from paddle_tpu_torch.ops.gpu import fused_adamw as fw

    p = torch.randn(n, device="cuda", generator=gen)
    g = torch.randn(n, device="cuda", generator=gen)
    m = 0.1 * torch.randn(n, device="cuda", generator=gen)
    v = 0.01 * torch.rand(n, device="cuda", generator=gen)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    scale = torch.tensor(0.5, device="cuda")
    kw = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3,
              bias_correction2=1 - 0.999 ** 3, grad_scale=scale)
    steps = torch.tensor(3.0, device="cuda")

    def check():
        got = fw.fused_adamw(kp, g, km, kv, **kw)
        want = fw.adamw_plain(p, g, m, v, **kw)
        return got, want

    def library():
        torch._fused_adamw_([kp], [g], [km], [kv], [], [steps], lr=1e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False,
                            grad_scale=None, found_inf=None)

    big = n > 1 << 26
    return dict(name="adamw", shape=[n], check=check,
                tol={torch.float32: (1e-6, 1e-6)},
                kernel=lambda: fw.fused_adamw(kp, g, km, kv, **kw),
                plain=lambda: fw.adamw_plain(p, g, m, v, **kw),
                library=library, nbytes=28 * n, nops=15 * n,
                iters=3 if big else 20, reps=3 if big else 5)



def _tables(torch, P, d, theta=10000.0):
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device="cuda") / d))
    f = torch.outer(torch.arange(P, dtype=torch.float32, device="cuda"), inv)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos().contiguous(), emb.sin().contiguous()


def run_case(torch, case, dtype):
    if "check" in case:
        got, want = case["check"]()
    else:
        got, want = case["kernel"](), case["plain"]()
    torch.cuda.synchronize()
    tol = case.get("tol")
    err = _compare(case["name"], case["shape"], dtype, got, want, tol)
    del got, want
    lib = case["library"]
    b_ms, b_by = bound_ms(case["nbytes"], case["nops"], dtype)
    reps = dict(iters=case.get("iters", 20), reps=case.get("reps", 5))
    row = {
        "phase": "kernels", "name": case["name"], "shape": case["shape"],
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "tolerance": (dict(zip(("atol", "rtol"), _tol(dtype))) if tol is None
                      else {str(k).replace("torch.", ""): dict(
                          zip(("rtol", "rms"), v)) for k, v in tol.items()}),
        "ms": time_ms(case["kernel"], **reps),
        "plain_ms": time_ms(case["plain"], **reps),
        "library_ms": time_ms(lib, **reps) if lib is not None else None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit(row)
    return row


def kernels_phase(torch):
    from paddle_tpu_torch.models.generation import packed_positions
    from paddle_tpu_torch.tools.profile_training import packed_batch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    # the packed slice's segment layout and per-document positions
    seg = torch.from_numpy(packed_batch(32000)[1]).cuda().contiguous()
    pos = packed_positions(seg, seg.shape[1]).contiguous()
    for dtype in (torch.bfloat16, torch.float32):
        cases = [
            ("rms_norm", rms_case(torch, gen, dtype, 8)),          # decode
            (None, rms_case(torch, gen, dtype, 256)),              # chunk
            ("rope", rope_case(torch, gen, dtype, 256)),           # chunk
            ("rope_packed", rope_packed_case(torch, gen, dtype, 8, 1)),
            (None, rope_packed_case(torch, gen, dtype, 8, 128)),   # batched
            # decode at the main path's table width (2048 / 16 = 128 pages):
            # the wrapper's own split count, then the single-split side
            ("paged_decode", paged_case(
                torch, gen, dtype, 8, 32, 32, 128, 16,
                [2048, 1791, 1500, 1203, 900, 611, 300, 17])),
            (None, paged_case(torch, gen, dtype, 8, 32, 32, 128, 16,
                              [2048, 1791, 1500, 1203, 900, 611, 300, 17],
                              splits=1)),
        ]
        for g, ctx in ((2, [77, 5, 300]), (4, [1, 129, 640]),
                       (8, [33, 1000, 16])):
            cases.append((None, paged_case(torch, gen, dtype, 3, 8 * g, 8,
                                           128, 16, ctx, splits=2)))
        # training at the packed Llama slice's shapes: RoPE with sign -1
        # (contiguous and per-token) and per-token RoPE forward at the
        # slice's positions; RMSNorm forward (y and rstd) and backward, whose
        # main path runs in fp32 under amp O1
        cases += [
            (None, rope_case(torch, gen, dtype, 4096, b=2, start=0,
                             sign=-1)),
            (None, rope_packed_case(torch, gen, dtype, 2, 4096, pos=pos)),
            (None, rope_packed_case(torch, gen, dtype, 2, 4096, pos=pos,
                                    sign=-1)),
            (None, rms_fwd_case(torch, gen, dtype, 8192)),
            ("rms_norm_bwd" if dtype == torch.float32 else None,
             rms_bwd_case(torch, gen, dtype, 8192)),
        ]
        for key, case in cases:
            row = run_case(torch, case, dtype)
            if key is not None and (dtype == torch.bfloat16
                                    or key == "rms_norm_bwd"):
                rows[key] = row
            del case
        cases = None
        torch.cuda.empty_cache()
        # training: GPT-3 1.3B's attention (main path), bench.py's "large"
        # preset's head size, and non-causal attention with sq != sk
        for geo, main in (((4, 2048, 2048, 16, 128, True), True),
                          ((8, 1024, 1024, 16, 64, True), False),
                          ((2, 1024, 2048, 16, 128, False), False)):
            for case in flash_cases(torch, gen, dtype, *geo):
                row = run_case(torch, case, dtype)
                if main and dtype == torch.bfloat16:
                    rows[case["name"]] = row
                del case
            torch.cuda.empty_cache()
        # segmented: the packed slice's attention (b 2, s 4096, h 32,
        # d 128, causal, bf16), and the small fp32 case with dead rows
        seg_cases = (seg_flash_cases(torch, gen, dtype, seg, 32, 128, True)
                     if dtype == torch.bfloat16 else no_live_key_check(
                         torch, gen))
        for case in seg_cases:
            row = run_case(torch, case, dtype)
            if dtype == torch.bfloat16:
                rows[case["name"]] = row
            del case
        seg_cases = None
        torch.cuda.empty_cache()
    # AdamW runs in fp32 only: GPT-3 1.3B's one flat group, a ragged one
    from paddle_tpu_torch.models import GPTConfig

    for n, main in ((gpt_numel(GPTConfig.gpt3_1p3b()), True),
                    (1_000_003, False)):
        row = run_case(torch, adamw_case(torch, gen, n), torch.float32)
        if main:
            rows["adamw"] = row
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------- served path
def top2_margin(torch, model, seq, t):
    """Gap between the two largest logits predicting token t of seq."""
    with torch.no_grad():
        ids = torch.tensor([seq[:t]], device=model.device)
        lg = model(ids)[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def parity_phase(torch, cfg, device, new_tokens=16, engine_kw=None,
                 prompt_lens=(700, 40, 23, 300)):
    """ServingEngine.generate vs model.generate, greedy, token for token."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=SEED)
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in prompt_lens]
    eng = ServingEngine(model, device=device, **(engine_kw or {}))
    got = eng.generate(prompts, max_new_tokens=new_tokens)
    for p, g in zip(prompts, got):
        want = model.generate(torch.tensor([p], device=model.device),
                              max_new_tokens=new_tokens)[0].tolist()
        if g != want:
            t = next(i for i, (a, b) in enumerate(zip(g, want)) if a != b)
            raise AssertionError(
                f"engine and generate() diverge at token {t} of a "
                f"{len(p)}-token prompt ({g[t]} vs {want[t]}); top-2 logit "
                f"margin there {top2_margin(torch, model, want, t):.3g}")
    st = eng.stats()
    return {"phase": "parity", "prompts": [len(p) for p in prompts],
            "new_tokens": new_tokens, "token_match": True,
            "batched_prefills": st["batched_prefills"],
            "prefill_programs": st["prefill_programs"]}


def slice_phase(torch, cfg, device, dtype, engine_kw, new_tokens,
                wave1_lens, prefix_len, reset, counts):
    """The main path: waves of requests through ServingEngine. Returns the
    phase summary; launch counts are read just after the drive."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=SEED)
    eng = ServingEngine(model, device=device, **engine_kw)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 1)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    shared = toks(prefix_len)
    lens = list(wave1_lens)
    wave1 = [toks(n) for n in lens[:-2]]
    wave1 += [shared + toks(lens[-2] - prefix_len),
              shared + toks(lens[-1] - prefix_len)]
    # wave 2: a partial prefix hit and a full-prompt (copy-on-write) hit
    repeat = next(p for p in wave1 if len(p) % engine_kw["block_size"] == 0)
    wave2 = [shared + toks(48), list(repeat)]
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    reqs = []
    decode_tick = None
    reset()
    t1 = time.perf_counter()
    for wave in (wave1, wave2):
        reqs += [eng.submit(p, max_new_tokens=new_tokens) for p in wave]
        while eng.sched.has_work():
            pure = not eng.sched.waiting and not eng.sched.prefilling
            before = counts()
            eng.step()
            if pure and decode_tick is None:
                after = counts()
                decode_tick = {k: after[k] - before[k] for k in after}
    sync()
    wall = time.perf_counter() - t1
    launches = counts()
    short = [r.request_id for r in reqs
             if len(r.output_tokens) != new_tokens
             or not all(0 <= t < cfg.vocab_size for t in r.output_tokens)]
    if short:
        raise AssertionError(f"requests without their {new_tokens} valid "
                             f"tokens: {short}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    st = eng.stats()
    if st["kv"]["used_blocks"] or not st["kv"]["conservation_ok"]:
        raise AssertionError(f"KV blocks leaked: {st['kv']}")
    generated = sum(len(r.output_tokens) for r in reqs)
    return {
        "phase": "slice", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "dtype": str(dtype),
        "requests": len(reqs), "prompt_tokens": [len(r.prompt) for r in reqs],
        "new_tokens_each": new_tokens, "init_s": init_s, "wall_s": wall,
        "engine_steps": st["steps"], "generated_tokens": generated,
        "tokens_per_s": generated / wall,
        "mean_ttft_s": statistics.mean(r.ttft_seconds() for r in reqs),
        "prefill_tokens": st["prefill_tokens"],
        "batched_prefills": st["batched_prefills"],
        "cow_admissions": st["cow_admissions"],
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if device != "cpu" else None),
        "kv_pool_bytes": eng.pool.nbytes(),
        "launches": launches, "launches_per_decode_tick": decode_tick,
    }


# ------------------------------------------------------------ training path
def _gpt_step(torch, model, opt, device, amp_on):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep

    def loss_fn(ids):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)

    return TrainStep(model, loss_fn, opt, device=device)


def _parity(torch, phase, models, make_loss, batch, steps, lr):
    """`steps` fp32 TrainSteps (AdamW, global-norm clip at 1.0) of each of
    models = {"cuda": ..., "cpu": ...}, holding the same weights, on the
    same batch; losses and parameters held to the bounds below. Adam divides
    each first moment by the root of the second, so its first step moves
    every element by lr in the sign of its gradient, whatever the
    gradient's size; an element whose gradient sits at fp32 rounding noise
    can step the other way on the other device, and so can one whose
    gradients nearly cancel later. Two such runs end at most 2 lr per step
    apart, hence every element within 2 lr * steps; the mean difference
    must stay under 1e-2 lr, which rounding alone meets. Losses must agree
    to 1e-4 relative."""
    import numpy as np
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["cuda"].state_dict().items()})
    losses = {}
    for device, model in models.items():
        opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, make_loss(model), opt, device=device)
        losses[device] = [step(*batch) for _ in range(steps)]
    got = [float(x) for x in losses["cuda"]]
    want = [float(x) for x in losses["cpu"]]
    rel = max(abs(g / w - 1) for g, w in zip(got, want))
    cpu = dict(models["cpu"].named_parameters())
    worst, total, count = 0.0, 0.0, 0
    for name, p in models["cuda"].named_parameters():
        diff = (p.detach().cpu() - cpu[name].detach()).abs()
        worst = max(worst, float(diff.max()))
        total += float(diff.sum())
        count += diff.numel()
    bounds = {"loss_rel": 1e-4, "param_max": 2 * lr * steps,
              "param_mean": 1e-2 * lr}
    row = {"phase": phase, "lr": lr, "loss_card": got, "loss_cpu": want,
           "max_rel_loss_diff": rel, "max_param_diff": worst,
           "mean_param_diff": total / count, "bounds": bounds}
    if not all(np.isfinite(got)) or rel > bounds["loss_rel"] \
            or worst > bounds["param_max"] \
            or total / count > bounds["param_mean"]:
        raise AssertionError(f"card and CPU training differ: {row}")
    return row


def train_parity_phase(torch, steps=3, lr=1e-5, batch=2, seq=128):
    """Three fp32 TrainSteps of a 2-layer full-width GPT on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batch (`_parity`'s bounds). Parameters: Adam divides
    each first moment by the root of the second, so its first step moves
    every element by lr in the sign of its gradient, whatever the
    gradient's size; an element whose gradient sits at fp32 rounding noise
    can step the other way on the other device, and so can one whose
    gradients nearly cancel later. Two such runs end at most 2 lr per step
    apart, hence every element within 2 lr * steps; the mean difference
    must stay under 1e-2 lr (1e-7, some fifty fp32 roundings of a weight
    of 0.02), which rounding alone meets. Elements that step apart also
    move the loss: at lr 1e-4 the third loss differed by 3.9e-4 relative
    (the second by 3.7e-6), so the phase runs at lr 1e-5, where that
    effect shrinks with the steps."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_layers = 2
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                               (batch, seq))
    models = {"cuda": GPTForCausalLM(cfg, device="cuda", seed=SEED),
              "cpu": GPTForCausalLM(cfg, device="cpu", seed=SEED)}

    def make_loss(model):
        return lambda x: model(x, labels=x)

    row = _parity(torch, "train_parity", models, make_loss, (ids,), steps,
                  lr)
    return {**row, "model": "GPT", "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "batch": [batch, seq]}


def packed_parity_phase(torch, steps=3, lr=1e-5, seq=256):
    """The packed Llama's `_parity`: Llama-2-7B widths, 2 layers, fp32, one
    packed row of `seq` tokens holding four documents and a padding tail
    (segmented flash, per-token RoPE and RMSNorm backward on the card, their
    plain versions on the CPU), three TrainSteps at lr 1e-5 as the GPT
    phase runs."""
    import numpy as np
    from paddle_tpu_torch.io import pack_examples
    from paddle_tpu_torch.tools.profile_training import packed_llama_config
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = packed_llama_config(layers=2)
    rng = np.random.default_rng(SEED + 3)
    docs = [rng.integers(0, cfg.vocab_size, n) for n in (70, 50, 90, 30)]
    ids, seg, labels = pack_examples(docs, seq)
    models = {"cuda": LlamaForCausalLM(cfg, device="cuda", seed=SEED),
              "cpu": LlamaForCausalLM(cfg, device="cpu", seed=SEED)}

    def make_loss(model):
        return lambda x, s, y: model(x, labels=y, segments=s)

    row = _parity(torch, "train_parity", models, make_loss,
                  (ids, seg, labels), steps, lr)
    return {**row, "model": "Llama packed", "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "batch": list(ids.shape),
            "documents": [len(d) for d in docs]}


def train_slice_phase(torch, reset, counts, batch=4, seq=2048, steps=3,
                      lr=1e-4):
    """Main path 2: GPT-3 1.3B, amp O1 (bf16 matmuls and attention, fp32
    parameters), AdamW as bench.py drives it, through TrainStep; one
    warm-up step, then `steps` timed steps on the same batch."""
    import math

    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.gpt3_1p3b()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, seed=SEED)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01)
    step = _gpt_step(torch, model, opt, None, amp_on=True)
    ids = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != gpt_numel(cfg):
        raise AssertionError(f"{n_params} parameters, {gpt_numel(cfg)} "
                             f"expected")
    torch.cuda.reset_peak_memory_stats()
    reset()
    t1 = time.perf_counter()
    losses = [step(ids)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    peak_first = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    launches = counts()
    losses = [float(x) for x in losses]
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"GPT-3 1.3B losses {losses}: the first should "
                             f"be within 0.5 of ln(vocab) = "
                             f"{math.log(cfg.vocab_size):.3f} and the last "
                             f"below it")
    groups = len(opt._groups)
    per_step = {k: v / (steps + 1) for k, v in launches.items()}
    want = {"flash_fwd": cfg.num_layers, "flash_dq": cfg.num_layers,
            "flash_dkv": cfg.num_layers, "adamw": groups}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want}")
    step_s = wall / steps
    return {
        "phase": "train_slice", "model": "GPT-3 1.3B", "params": n_params,
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "amp": "O1 bfloat16", "batch": [batch, seq], "init_s": init_s,
        "warmup_step_s": warm_s, "losses": losses, "step_s": step_s,
        "tokens_per_s": batch * seq / step_s,
        "peak_mem_bytes": max(peak_first, torch.cuda.max_memory_allocated()),
        "peak_mem_bytes_timed_steps": torch.cuda.max_memory_allocated(),
        "adamw_groups": groups, "launches": launches,
        "launches_per_step": per_step,
    }


def train_packed_slice_phase(torch, reset, counts, rows=2, seq=4096,
                             steps=3, lr=1e-4):
    """Main path 3: Llama-2-7B at its published widths, depth cut to 8
    layers, amp O1 (bf16 matmuls and attention, fp32 parameters and
    RMSNorm), AdamW, through TrainStep on one packed batch of `rows` x
    `seq` tokens from PackedLMBatches (seeded documents of 64-2048 tokens);
    one warm-up step, then `steps` timed steps on the same batch."""
    import math

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.profile_training import (packed_batch,
                                                         packed_llama_config)

    cfg = packed_llama_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=SEED)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01)

    def loss_fn(ids, seg, labels):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(ids, labels=labels, segments=seg)

    step = TrainStep(model, loss_fn, opt)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in packed_batch(cfg.vocab_size, rows, seq))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    real = int((batch[1] >= 0).sum())
    docs = int(sum(torch.unique(r[r >= 0]).numel() for r in batch[1]))
    torch.cuda.reset_peak_memory_stats()
    reset()
    t1 = time.perf_counter()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    peak_first = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    launches = counts()
    losses = [float(x) for x in losses]
    per_step = {k: v / (steps + 1) for k, v in launches.items()}
    L = cfg.num_layers
    want = {"flash_seg_fwd": L, "flash_seg_dq": L, "flash_seg_dkv": L,
            "rms_norm": 2 * L + 1, "rms_norm_bwd": 2 * L + 1,
            "rope_packed": 4 * L, "adamw": len(opt._groups),
            "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "rope": 0}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want}")
    # random weights (std 0.02) give logits of std 0.02 * sqrt(4096) = 1.28
    # after the final RMSNorm: the first loss sits near ln(vocab) + 1.28^2 /
    # 2 = 11.19, so within 1.0 of ln(vocab); the repeated batch must fall
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 1.0 \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"packed Llama losses {losses}: the first "
                             f"should be within 1.0 of ln(vocab) = "
                             f"{math.log(cfg.vocab_size):.3f} and the last "
                             f"below it")
    step_s = wall / steps
    return {
        "phase": "train_packed_slice",
        "model": f"Llama-2-7B widths, {L} layers", "params": n_params,
        "layers": L, "hidden": cfg.hidden_size, "amp": "O1 bfloat16",
        "batch": [rows, seq], "documents": docs, "real_tokens": real,
        "init_s": init_s, "warmup_step_s": warm_s, "losses": losses,
        "step_s": step_s, "tokens_per_s": rows * seq / step_s,
        "real_tokens_per_s": real / step_s,
        "peak_mem_bytes_warmup": peak_first,
        "peak_mem_bytes_timed_steps": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": per_step,
    }


KERNELS = {
    "rms_norm": ("triton", "paddle_tpu_torch/ops/gpu/fused_norm.py",
                 "paddle_tpu/ops/pallas/fused_norm.py:24"),
    "rms_norm_bwd": ("triton", "paddle_tpu_torch/ops/gpu/fused_norm.py",
                     "paddle_tpu/ops/pallas/fused_norm.py:33"),
    "rope": ("triton", "paddle_tpu_torch/ops/gpu/rope.py",
             "paddle_tpu/ops/pallas/rope.py:22"),
    "rope_packed": ("triton", "paddle_tpu_torch/ops/gpu/rope.py",
                    "paddle_tpu/ops/pallas/rope.py:126"),
    "paged_decode": ("cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:50"),
    "flash_fwd": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                  "paddle_tpu/ops/pallas/flash_attention.py:53"),
    "flash_dq": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:137"),
    "flash_dkv": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                  "paddle_tpu/ops/pallas/flash_attention.py:177"),
    "flash_seg_fwd": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:411"),
    "flash_seg_dq": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:455"),
    "flash_seg_dkv": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:494"),
    "adamw": ("triton", "paddle_tpu_torch/ops/gpu/fused_adamw.py",
              "paddle_tpu/ops/pallas/fused_adamw.py:21"),
}
SERVING = ("rms_norm", "rope", "rope_packed", "paged_decode")
TRAINING = ("flash_fwd", "flash_dq", "flash_dkv", "adamw")
# the packed slice's kernels, and those it must not launch (read as 0)
PACKED = ("flash_seg_fwd", "flash_seg_dq", "flash_seg_dkv", "rms_norm",
          "rms_norm_bwd", "rope_packed", "adamw", "flash_fwd", "flash_dq",
          "flash_dkv", "rope")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.models import LlamaConfig
        from paddle_tpu_torch.ops import gpu
        from paddle_tpu_torch.ops.gpu import _build
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2

    card = nvidia_smi()
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": card, "capability": list(cap),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {k: v["seconds"] for k, v in built.items()},
          "ptxas": [ln.strip() for v in built.values()
                    for ln in v["log"].splitlines() if "Used" in ln]})

    rows = kernels_phase(torch)
    torch.cuda.empty_cache()

    cfg2 = LlamaConfig.llama2_7b()
    cfg2.num_layers = 2
    emit(parity_phase(torch, cfg2, "cuda", engine_kw=dict(
        max_slots=4, block_size=16, prefill_chunk=256, max_model_len=1024)))
    torch.cuda.empty_cache()

    summary = slice_phase(
        torch, LlamaConfig.llama2_7b(), "cuda", "bfloat16",
        dict(max_slots=8, block_size=16, prefill_chunk=256,
             max_model_len=2048),
        new_tokens=64, wave1_lens=(16, 64, 128, 512, 768, 1024, 288, 356),
        prefix_len=256, reset=gpu.reset_launch_counts,
        counts=lambda: gpu.launch_counts(SERVING))
    emit(summary)
    torch.cuda.empty_cache()

    emit(train_parity_phase(torch))
    torch.cuda.empty_cache()

    train = train_slice_phase(torch, gpu.reset_launch_counts,
                              lambda: gpu.launch_counts(TRAINING))
    emit(train)
    torch.cuda.empty_cache()

    emit(packed_parity_phase(torch))
    torch.cuda.empty_cache()

    packed = train_packed_slice_phase(torch, gpu.reset_launch_counts,
                                      lambda: gpu.launch_counts(PACKED))
    emit(packed)
    # each kernel's launches on the path it was ported for: serving for
    # RMSNorm, RoPE and paged decode, GPT training for dense flash and
    # AdamW, packed Llama training for segmented flash and RMSNorm backward
    launches = {**packed["launches"], **train["launches"],
                **summary["launches"]}

    print(card, flush=True)
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:           # any failed phase: report it, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
