"""The port's packed-document pretraining slice against the JAX reference, on
the CPU.

Segmented flash attention (forward, dQ, dK/dV), the RMSNorm backward and
the RoPE backward (contiguous and per-token) through the port's autograd
Functions, whose CPU side runs the kernels' plain versions, held against
the reference's Pallas kernels in interpret mode and their jax.vjp; the
packing helpers and per-document positions against the reference's arrays;
tiny Llama (GQA) and GPT on packed rows against the JAX models with the same
weights, their Pallas kernels in interpret mode (FLAGS_pallas_interpret, set
around the reference's calls and reset after, as
tests/test_torch_training.py does), and packed against padded; three packed
TrainSteps of a one-layer tiny Llama in fp32 and amp O1 against the
reference's compiled TrainStep, which runs its XLA compositions there
(dense block-diagonal mask, XLA RMSNorm and RoPE: an implementation
independent of the kernels, and a quarter of the compile time). The CUDA
and Triton kernels are held against the same plain versions on the card by
chip_smoke.py.

Tolerances are stated beside each comparison. The general rule: float32 to
1e-5 of the value plus 1e-5 of the output's RMS (the same fp32 arithmetic
in another order); bfloat16 to one bf16 rounding (2**-7) of the value plus
one of the RMS (both sides round the same fp32 result once; in a backward
one rounding of an input enters at the scale of the gradient's RMS).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu.io import packing as jpacking
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.ops.kernels import nn_ops as jops
from paddle_tpu.ops.pallas import fused_norm as jnorm
from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.io import IGNORE_LABEL, PackedLMBatches, pack_examples
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_jax_state_dict)
from paddle_tpu_torch.models.generation import packed_positions
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.ops.gpu import flash_attention as tflash
from paddle_tpu_torch.ops.gpu import fused_norm, rope
from paddle_tpu_torch.optimizer import AdamW

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BLOCK = 16          # Pallas blocks, as tests/test_pallas.py runs them
STEPS = 3
LR = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tdt):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    tol = 1e-5 if tdt == torch.float32 else 2.0 ** -7
    err = np.abs(got - want)
    assert (err <= tol * (np.abs(want) + rms)).all(), (err.max(), rms)


def _pair(a, jdt, tdt):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


# ------------------------------------------------- segmented flash attention
def _segments():
    """[2, 64] ids: documents crossing the 16-row block edges (0-20, 20-45,
    45-56 in row 0), a -1 padding tail in row 1."""
    seg = np.zeros((2, 64), np.int32)
    seg[0, 20:45] = 1
    seg[0, 45:56] = 2
    seg[0, 56:] = 3
    seg[1, 7:39] = 1
    seg[1, 39:50] = 2
    seg[1, 50:] = -1
    return seg


@pytest.mark.parametrize("dt,d,causal", [("f32", 32, True),
                                         ("bf16", 64, False)])
def test_segmented_flash_matches_pallas(dt, d, causal):
    """Forward (o and lse) and dQ/dK/dV through the port's autograd Function
    against flash_attention_segmented in interpret mode and its jax.vjp."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(d)
    seg = _segments()
    b, s, h = 2, 64, 2
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrs)
    q, k, v, do = (torch.from_numpy(a.copy()).to(tdt) for a in arrs)
    scale = d ** -0.5

    def pallas(a, b_, c):
        return jflash.flash_attention_segmented(
            a, b_, c, jnp.asarray(seg), scale, causal, BLOCK, BLOCK, True)

    po, vjp = jax.vjp(pallas, jq, jk, jv)
    grads = vjp(jdo)
    _, res = jflash._seg_fwd(jq, jk, jv, jnp.asarray(seg), scale, causal,
                             BLOCK, BLOCK, True)

    tseg = torch.from_numpy(seg)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = tflash.flash_attention_segmented(q, k, v, tseg, scale, causal)
    o.backward(do)
    _, lse = tflash.flash_seg_fwd_plain(q.detach(), k.detach(), v.detach(),
                                        tseg, tseg, scale, causal)
    assert o.dtype == tdt and q.grad.dtype == tdt
    _close(o, po, tdt)
    _close(lse, np.asarray(res[5])[..., 0], torch.float32)
    for got, want in zip((q.grad, k.grad, v.grad), grads):
        _close(got, want, tdt)


def _pallas_seg_split(q, k, v, do, seg_q, seg_k, scale, causal):
    """The three segmented Pallas kernels in interpret mode, as `_seg_fwd`
    and `_seg_bwd` launch them, but with separate query and key segment ids
    (the reference's wrappers pass one array for both). Returns o, lse
    [b * h, s], dq, dk, dv."""
    b, s, h, d = q.shape
    bh, n = b * h, s // BLOCK

    def heads(x):
        return x.transpose(0, 2, 1, 3).reshape(bh, s, d)

    qr, kr, vr, dor = map(heads, (q, k, v, do))
    sq3, sk3 = seg_q.reshape(b, s, 1), seg_k.reshape(b, s, 1)
    blk = pl.BlockSpec((None, BLOCK, d), lambda i, j: (i, j, 0))
    full = pl.BlockSpec((None, s, d), lambda i, j: (i, 0, 0))
    seg_blk = pl.BlockSpec((None, BLOCK, 1), lambda i, j: (i // h, j, 0))
    seg_full = pl.BlockSpec((None, s, 1), lambda i, j: (i // h, 0, 0))
    row_blk = pl.BlockSpec((None, BLOCK, 1), lambda i, j: (i, j, 0))
    row_full = pl.BlockSpec((None, s, 1), lambda i, j: (i, 0, 0))
    sds = jax.ShapeDtypeStruct
    o, lse = pl.pallas_call(
        functools.partial(jflash._fwd_seg_kernel, scale=scale,
                          causal=causal, block_k=BLOCK, sk=s),
        grid=(bh, n), in_specs=[blk, full, full, seg_blk, seg_full],
        out_specs=[blk, row_blk],
        out_shape=[sds((bh, s, d), q.dtype), sds((bh, s, 1), jnp.float32)],
        interpret=True)(qr, kr, vr, sq3, sk3)
    delta = jnp.sum(dor.astype(jnp.float32) * o.astype(jnp.float32), -1,
                    keepdims=True)
    dq = pl.pallas_call(
        functools.partial(jflash._bwd_seg_kernel, scale=scale,
                          causal=causal, block_k=BLOCK, sk=s),
        grid=(bh, n),
        in_specs=[blk, full, full, seg_blk, seg_full, blk, row_blk, row_blk],
        out_specs=blk, out_shape=sds((bh, s, d), q.dtype),
        interpret=True)(qr, kr, vr, sq3, sk3, dor, lse, delta)
    dk, dv = pl.pallas_call(
        functools.partial(jflash._dkv_seg_kernel, scale=scale,
                          causal=causal, block_q=BLOCK, sq=s),
        grid=(bh, n),
        in_specs=[full, blk, blk, seg_full, seg_blk, full, row_full,
                  row_full],
        out_specs=[blk, blk],
        out_shape=[sds((bh, s, d), k.dtype), sds((bh, s, d), v.dtype)],
        interpret=True)(qr, kr, vr, sq3, sk3, dor, lse, delta)

    def un(x):
        return x.reshape(b, h, s, d).transpose(0, 2, 1, 3)

    return un(o), lse[..., 0], un(dq), un(dk), un(dv)


def test_segmented_flash_row_with_no_live_key():
    """Query rows whose segment id no key carries (fp32, d 32, full): o is
    exactly 0 (and so is dq) in the Pallas kernels and in the plain
    versions, and everything else matches the kernels to the fp32 rule.
    Their lse is the mask value (-1e30 + log 1e-30) on both sides and is
    compared on the live rows."""
    causal = False
    rng = np.random.default_rng(5)
    seg_k = _segments()
    seg_q = seg_k.copy()
    seg_q[0, 3] = seg_q[1, 60] = 9          # no key carries id 9
    b, s, h, d = 2, 64, 2, 32
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]
    scale = d ** -0.5
    want = _pallas_seg_split(*(jnp.asarray(a) for a in arrs),
                             jnp.asarray(seg_q), jnp.asarray(seg_k), scale,
                             causal)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    tq, tk = torch.from_numpy(seg_q), torch.from_numpy(seg_k)
    o, lse = tflash.flash_seg_fwd_plain(q, k, v, tq, tk, scale, causal)
    delta = tflash.attention_delta(o, do)
    args = (q, k, v, tq, tk, do, lse, delta, scale, causal)
    dq = tflash.flash_seg_dq_plain(*args)
    dk, dv = tflash.flash_seg_dkv_plain(*args)
    dead = seg_q != seg_k
    for got, ref in ((o, want[0]), (dq, want[2])):
        assert (_np(got)[dead] == 0).all()
        assert (np.asarray(ref)[dead] == 0).all()
    live_rows = ~np.repeat(dead, h, axis=0)           # [b * h, s]
    assert (_np(lse)[~live_rows] < -1e29).all()
    _close(_np(lse)[live_rows], np.asarray(want[1])[live_rows],
           torch.float32)
    for got, ref in zip((o, dq, dk, dv), (want[0],) + want[2:]):
        _close(got, ref, torch.float32)


@pytest.mark.parametrize("causal", [False, True],
                         ids=["full", "causal"])
def test_tensor_core_arithmetic_segmented_matches_pallas(causal):
    """bf16, d 32: the tensor-core kernels' arithmetic (tiles, online
    softmax, P and dS as two bf16 terms; `_emulate_fwd` / `_emulate_dkv` of
    tests/test_torch_flash.py) against the three segmented Pallas kernels in
    interpret mode, with rows whose id no key carries: their o is exactly 0
    on both sides, and so are dK and dV of keys no query sees."""
    from test_torch_flash import _emulate_dkv, _emulate_fwd

    rng = np.random.default_rng(7)
    seg_k = _segments()
    seg_q = seg_k.copy()
    seg_q[0, 3] = seg_q[1, 60] = 9          # no key carries id 9
    seg_q[1, 39:50] = 4                     # rows 39-49 of row 1: neither
    #                                         side has a live pair
    b, s, h, d = 2, 64, 2, 32
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]
    scale = d ** -0.5
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    want = _pallas_seg_split(*jin, jnp.asarray(seg_q), jnp.asarray(seg_k),
                             scale, causal)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    tq, tk = torch.from_numpy(seg_q), torch.from_numpy(seg_k)
    o, lse = _emulate_fwd(q, k, v, scale, causal, tq, tk)
    delta = tflash.attention_delta(o, do)
    dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, causal, tq, tk)
    dead_q = (seg_q[:, :, None] != seg_k[:, None, :]).all(-1)
    dead_k = (seg_q[:, None, :] != seg_k[:, :, None]).all(-1)
    assert dead_q.sum() == 13 and dead_k.sum() == 11
    assert (_np(o)[dead_q] == 0).all()
    assert (_np(want[0])[dead_q] == 0).all()
    for got, ref in ((dk, want[3]), (dv, want[4])):
        assert (_np(got)[dead_k] == 0).all()
        assert (_np(ref)[dead_k] == 0).all()
    live_rows = ~np.repeat(dead_q, h, axis=0)
    _close(_np(lse)[live_rows], np.asarray(want[1])[live_rows],
           torch.float32)
    for got, ref in ((o, want[0]), (dk, want[3]), (dv, want[4])):
        _close(got, ref, torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True],
                         ids=["full", "causal"])
def test_tensor_core_dq_segmented_matches_pallas(causal):
    """bf16, d 32: the tensor-core dQ's arithmetic (`_emulate_dq` of
    tests/test_torch_flash.py: 64-key tiles, P set to 0 off the live pairs,
    dS as two bf16 terms) from the emulated forward's o and lse, against
    the segmented Pallas dQ kernel in interpret mode; rows whose id no key
    carries get dq = 0 exactly on both sides."""
    from test_torch_flash import _emulate_dq, _emulate_fwd

    rng = np.random.default_rng(8)
    seg_k = _segments()
    seg_q = seg_k.copy()
    seg_q[0, 3] = seg_q[1, 60] = 9          # no key carries id 9
    b, s, h, d = 2, 64, 2, 32
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]
    scale = d ** -0.5
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    want = _pallas_seg_split(*jin, jnp.asarray(seg_q), jnp.asarray(seg_k),
                             scale, causal)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    tq, tk = torch.from_numpy(seg_q), torch.from_numpy(seg_k)
    o, lse = _emulate_fwd(q, k, v, scale, causal, tq, tk)
    delta = tflash.attention_delta(o, do)
    dq = _emulate_dq(q, k, v, do, lse, delta, scale, causal, tq, tk)
    dead_q = (seg_q[:, :, None] != seg_k[:, None, :]).all(-1)
    assert dead_q.sum() == 2
    assert (_np(dq)[dead_q] == 0).all()
    assert (_np(want[2])[dead_q] == 0).all()
    _close(dq, want[2], torch.bfloat16)


def test_segmented_attention_dispatch():
    """nn_ops.segmented_attention and flash_attn_unpadded take the kernel
    path inside the reference's gate and the dense-mask composition outside
    it; both match the reference's op (dense fallback, interpret off) to the
    fp32 rule. The unpadded op needs the same offsets OBJECT for q and k."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 128, 2, 32
    seg = np.zeros((b, s), np.int32)
    seg[:, 50:100] = 1
    seg[:, 100:] = 2
    seg[1, 120:] = -1
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    want = jops.segmented_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    jnp.asarray(seg), causal=True)
    cu = np.array([0, 40, 100, 128], np.int32)
    want_u = jops.flash_attn_unpadded(
        *(jnp.asarray(a[0]) for a in (q, k, v)), jnp.asarray(cu),
        jnp.asarray(cu), 60, 60, causal=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kernel = tops.segmented_attention(tq, tk, tv, torch.from_numpy(seg))
    tflags.set_flags({"use_flash_attention": False})
    try:
        composed = tops.segmented_attention(tq, tk, tv,
                                            torch.from_numpy(seg))
    finally:
        tflags.set_flags({"use_flash_attention": True})
    _close(kernel, want, torch.float32)
    _close(composed, want, torch.float32)
    tcu = torch.from_numpy(cu)
    for cu_k in (tcu, tcu.clone()):          # kernel path, then the mask
        got = tops.flash_attn_unpadded(tq[0], tk[0], tv[0], tcu, cu_k, 60,
                                       60, causal=True)
        _close(got, want_u, torch.float32)


# ---------------------------------------------------------- RMSNorm, RoPE
@pytest.mark.parametrize("dt,shape", [("f32", (3, 7, 64)),
                                      ("bf16", (40, 128))],
                         ids=["f32-21rows", "bf16-40rows"])
def test_rms_norm_backward_matches_pallas(dt, shape):
    """dx, dw (and the saved rstd) against fused_rms_norm's VJP in
    interpret mode with 16-row blocks, which n does not divide (the
    reference's padding path). dw comes back in w's dtype."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(4)
    x, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    (jx, tx), (jw, tw), (jg, tg) = (_pair(a, jdt, tdt) for a in (x, w, g))
    y, vjp = jax.vjp(lambda a, b_: jnorm.fused_rms_norm(a, b_, 1e-5, BLOCK,
                                                        True), jx, jw)
    jdx, jdw = vjp(jg)
    _, (_, _, jrstd, _) = jnorm._run_fwd(jx, jw, 1e-5, BLOCK, True)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    out = fused_norm.fused_rms_norm(tx, tw, 1e-5)
    out.backward(tg)
    _, rstd = fused_norm.rms_norm_fwd_plain(tx.detach(), tw.detach(), 1e-5)
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    _close(out, y, tdt)
    _close(rstd, jrstd, torch.float32)
    _close(tx.grad, jdx, tdt)
    _close(tw.grad, jdw, tdt)


def _rope_tables(P, d, theta=10000.0):
    inv = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float32) / d)
    f = np.outer(np.arange(P, dtype=np.float32), inv)
    emb = np.concatenate([f, f], -1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@pytest.mark.parametrize("dt,packed", [("f32", True), ("bf16", False)],
                         ids=["f32-per_token", "bf16-contiguous"])
def test_rope_backward_matches_pallas(dt, packed):
    """Gradients of q and k (GQA: k has 2 heads of 4) through the port's
    autograd Functions (the forward kernel with sign -1) against jax.vjp of
    fused_rope / fused_rope_packed in interpret mode."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(6)
    b, s, d = 2, 16, 32
    q, gq = (rng.standard_normal((b, s, 4, d)).astype(np.float32)
             for _ in range(2))
    k, gk = (rng.standard_normal((b, s, 2, d)).astype(np.float32)
             for _ in range(2))
    cos, sin = _rope_tables(24, d)
    pos = np.stack([np.arange(10, 10 + s), rng.integers(0, 24, s)]).astype(
        np.int32)
    if packed:
        tabs = (cos, sin, pos)

        def jfn(a, b_):
            return jrope.fused_rope_packed(a, b_, *map(jnp.asarray, tabs),
                                           interpret=True)
        tfn = rope.fused_rope_packed
    else:
        tabs = (cos[:s], sin[:s])

        def jfn(a, b_):
            return jrope.fused_rope(a, b_, *map(jnp.asarray, tabs),
                                    interpret=True)
        tfn = rope.fused_rope
    (jq, tq), (jk, tk), (jgq, tgq), (jgk, tgk) = (
        _pair(a, jdt, tdt) for a in (q, k, gq, gk))
    _, vjp = jax.vjp(jfn, jq, jk)
    want = vjp((jgq, jgk))
    tq.requires_grad_(True)
    tk.requires_grad_(True)
    outs = tfn(tq, tk, *map(torch.from_numpy, tabs))
    torch.autograd.backward(outs, (tgq, tgk))
    for got, ref in zip((tq.grad, tk.grad), want):
        assert got.dtype == tdt
        _close(got, ref, tdt)


def test_no_grad_calls_skip_autograd():
    """Where no gradient is wanted (serving), RMSNorm and both RoPEs give
    the same values as their autograd Functions with no graph node, and
    the RMSNorm forward keeps no rstd."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, 16)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(16)).astype(
        np.float32)).requires_grad_(True)
    cos, sin = map(torch.from_numpy, _rope_tables(8, 16))
    pos = torch.from_numpy(rng.integers(0, 8, (2, 6)).astype(np.int32))
    calls = (lambda: (fused_norm.fused_rms_norm(x, w, 1e-5),),
             lambda: rope.fused_rope(x, x, cos[:6], sin[:6]),
             lambda: rope.fused_rope_packed(x, x, cos, sin, pos))
    for call in calls:
        with_grad = call()
        with torch.no_grad():
            without = call()
        for a, b_ in zip(with_grad, without):
            assert a.grad_fn is not None and b_.grad_fn is None
            assert torch.equal(a.detach(), b_)
    y, rstd = fused_norm.rms_norm_fwd(x.detach(), w.detach(), 1e-5,
                                      with_rstd=False)
    assert rstd is None
    assert torch.equal(y, fused_norm.rms_norm_plain(x.detach(), w.detach(),
                                                    1e-5))


# -------------------------------------------------------------- packing
def _docs(rng, n, lo, hi, vocab=512):
    return [rng.integers(0, vocab, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, n)]


def test_packing_and_positions_equal_the_reference():
    """pack_examples (both split modes), PackedLMBatches and
    packed_positions give the reference's arrays exactly."""
    rng = np.random.default_rng(7)
    docs = _docs(rng, 23, 3, 40)
    for split in (True, False):
        got = pack_examples(docs, 32, pad_id=5, split_docs=split)
        want = jpacking.pack_examples(docs, 32, pad_id=5, split_docs=split)
        for a, b_ in zip(got, want):
            assert a.dtype == b_.dtype
            np.testing.assert_array_equal(a, b_)
        seg = got[1]
        np.testing.assert_array_equal(
            packed_positions(torch.from_numpy(seg), 32).numpy(),
            np.asarray(jgen.packed_positions(jnp.asarray(seg), 32)))
    for drop_last in (True, False):
        got = list(PackedLMBatches(docs, 32, 3, drop_last=drop_last))
        want = list(jpacking.PackedLMBatches(docs, 32, 3,
                                             drop_last=drop_last))
        assert len(got) == len(want) > 0
        for gb, wb in zip(got, want):
            for a, b_ in zip(gb, wb):
                np.testing.assert_array_equal(a, b_)
    with pytest.raises(RuntimeError, match="one-shot"):
        gen = iter(docs)
        for _ in range(2):
            list(PackedLMBatches(gen, 32, 3))


# ------------------------------------------------------------ the models
def _llama_pair(layers=2):
    """The tiny configs (GQA: 4 heads, 2 KV heads), depth `layers`."""
    cfgs = JaxLlamaConfig.tiny(), LlamaConfig.tiny()
    for c in cfgs:
        c.num_layers = layers
    paddle.seed(0)
    jm = JaxLlama(cfgs[0])
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(cfgs[1], device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _gpt_pair():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _packed_batch(seed, vocab):
    """Two packed rows of 128 tokens (the flash gate's length): documents
    of 10-70 tokens split at row ends, and a padding tail."""
    rng = np.random.default_rng(seed)
    return pack_examples(_docs(rng, 6, 10, 70, vocab), 128)


def _padded(docs, cap):
    ids = np.zeros((len(docs), cap), np.int32)
    labels = np.full((len(docs), cap), IGNORE_LABEL, np.int64)
    for i, d in enumerate(docs):
        ids[i, :len(d)] = d
        labels[i, :len(d)] = d
    return ids, labels


@pytest.mark.parametrize("name", ["llama_gqa", "gpt"])
def test_packed_forward_matches_the_reference_and_padded(name):
    """fp32, weights carried across: packed logits to 1e-4 absolute (fp32
    over two blocks, as the GPT test holds them) and the packed loss to 1e-5
    relative against the JAX model (its Pallas kernels in interpret mode).
    Then the reference's own property (test_packed_varlen.py): whole
    documents packed in rows give the same loss as the same documents
    padded one to a row, without segments (1e-5 relative)."""
    jm, tm = _llama_pair() if name == "llama_gqa" else _gpt_pair()
    vocab = tm.config.vocab_size
    ids, seg, labels = _packed_batch(8, vocab)
    assert (seg[:, -1] == -1).any()
    jt = [paddle.to_tensor(a) for a in (ids, seg, labels)]
    tt = [torch.from_numpy(a) for a in (ids, seg, labels)]
    paddle.set_flags({"pallas_interpret": True})
    try:
        want_logits = _np(jm(jt[0], segments=jt[1]))
        want_loss = float(jm(jt[0], labels=jt[2], segments=jt[1]).numpy())
    finally:
        paddle.set_flags({"pallas_interpret": False})
    with torch.no_grad():
        got_logits = _np(tm(tt[0], segments=tt[1]))
        got_loss = float(tm(tt[0], labels=tt[2], segments=tt[1]))
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4, rtol=0)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)

    docs = _docs(np.random.default_rng(9), 5, 20, 60, vocab)
    ids, seg, labels = pack_examples(docs, 128, split_docs=False)
    pids, plabels = _padded(docs, 128)
    with torch.no_grad():
        packed = float(tm(torch.from_numpy(ids),
                          labels=torch.from_numpy(labels),
                          segments=torch.from_numpy(seg)))
        padded = float(tm(torch.from_numpy(pids),
                          labels=torch.from_numpy(plabels)))
    assert packed == pytest.approx(padded, rel=1e-5)


def test_packed_loss_masks_boundary_pairs():
    """Changing document 1 changes nothing of document 2's loss when only
    its labels count (the reference's test_llama_packed_boundary_pairs_
    masked): exact equality, since document 2 never sees document 1."""
    _, tm = _llama_pair()
    rng = np.random.default_rng(10)
    d2 = rng.integers(0, 512, 60).astype(np.int32)
    losses = []
    for _ in range(2):
        d1 = rng.integers(0, 512, 60).astype(np.int32)
        ids, seg, labels = pack_examples([d1, d2], 128)
        labels = np.where(seg == 1, labels, IGNORE_LABEL)
        with torch.no_grad():
            losses.append(float(tm(torch.from_numpy(ids),
                                   labels=torch.from_numpy(labels),
                                   segments=torch.from_numpy(seg))))
    assert losses[0] == losses[1]


def _train_both(amp_on):
    jm, tm = _llama_pair(layers=1)
    batch = next(iter(PackedLMBatches(
        _docs(np.random.default_rng(11), 12, 10, 70), 128, 2)))
    jopt = JaxAdamW(LR, parameters=jm.parameters(), weight_decay=0.01,
                    grad_clip=JaxClip(1.0))
    topt = AdamW(LR, parameters=tm.parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))

    def jloss(ids, seg, labels):
        with paddle.amp.auto_cast(enable=amp_on, level="O1",
                                  dtype="bfloat16"):
            return jm(ids, labels=labels, segments=seg)

    def tloss(ids, seg, labels):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            return tm(ids, labels=labels, segments=seg)

    jstep = JaxTrainStep(jm, jloss, jopt)
    jl = [float(jstep(*(paddle.to_tensor(a) for a in batch)).numpy())
          for _ in range(STEPS)]
    tstep = TrainStep(tm, tloss, topt, device="cpu")
    tl = [float(tstep(*batch)) for _ in range(STEPS)]
    jp = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tp = {k: _np(v) for k, v in tm.state_dict().items()}
    return jl, tl, jp, tp


def test_packed_train_steps_match_the_reference_fp32():
    """Three fp32 steps on one packed batch (ids, segments, labels from
    PackedLMBatches straight into TrainStep): losses to 1e-5 relative.
    Parameters: the first step's gradients agree to ~1e-5 of each
    parameter's RMS (measured), but Adam divides each first moment by the
    root of the second, so its first step moves every element by lr in the
    sign of its gradient, and an element whose gradient sits within that
    rounding of 0 (a few in 10^5 here: single-token document tails, whose
    query gradient is 0 but for rounding) can step the other way; such an
    element ends at most 2 lr a step away. So: every element within
    2 lr * steps, at most 1 in 10^4 beyond 0.1 lr, and the mean absolute
    difference under 1e-3 lr (measured 3e-4 lr)."""
    jl, tl, jp, tp = _train_both(amp_on=False)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    diff = np.concatenate([np.abs(tp[k] - jp[k]).ravel() for k in jp])
    assert diff.max() <= 2 * LR * STEPS
    assert (diff > 0.1 * LR).mean() <= 1e-4
    assert diff.mean() <= 1e-3 * LR


def test_packed_train_steps_match_the_reference_amp_o1():
    """Three amp O1 (bf16) steps: losses to 1e-3 relative, a quarter of one
    bf16 rounding: both packages round the matmuls and attention to bf16,
    but not always the same values (SwiGLU's product and the residual adds
    round at other places), and the mean over the batch's tokens averages
    that down."""
    jl, tl, _, _ = _train_both(amp_on=True)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
