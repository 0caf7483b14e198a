"""The port's flash attention against the JAX reference, on the CPU.

paddle_tpu_torch/ops/gpu/flash_attention.py holds three CUDA kernels (the
forward, dQ and dK/dV), their plain PyTorch versions and the autograd
Function that joins them; on CPU tensors the Function runs the plain
versions. These tests hold the forward and the gradients it gives against
the reference's Pallas kernels in interpret mode (`flash_attention(...,
interpret=True)` and its `jax.vjp`) and against its XLA pair `_dense_fwd` /
`_dense_bwd`, on the same numpy inputs. The CUDA kernels are held against
the same plain versions on the card by chip_smoke.py; the arithmetic of the
tensor-core kernels (tiles, online softmax, P and dS as two bf16 terms) is
emulated below and held to the same bounds here.

Tolerances: float32 to 1e-5 of the value plus 1e-5 of the output's RMS
(both sides do the same fp32 arithmetic in another order); bfloat16 to one
bf16 rounding (2**-7) of the value plus one of the output's RMS: both sides
round the same fp32 result once, and in the backward each side forms
delta = rowsum(dO * O) from its own rounded O, so one rounding of O enters
the gradients at the scale of their RMS.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import nn_ops as jops
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.ops.gpu import flash_attention as tflash

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

DTYPES = [("f32", jnp.float32, torch.float32),
          ("bf16", jnp.bfloat16, torch.bfloat16)]
# (b, sq, sk, h, d, causal)
SHAPES = [(2, 128, 128, 2, 32, True), (1, 256, 256, 2, 64, True),
          (2, 256, 256, 2, 32, False), (1, 128, 256, 2, 64, False)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tdt):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}[tdt]
    err = np.abs(got - want)
    bound = tol * (np.abs(want) + rms)
    worst = np.unravel_index(np.argmax(err / bound), err.shape)
    assert (err <= bound).all(), \
        (err.max(), rms, worst, float(got[worst]), float(want[worst]),
         float(bound[worst]))


def _inputs(shape, jdt, tdt, seed=0):
    b, sq, sk, h, d, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, n, h, d)).astype(np.float32)
            for n in (sq, sk, sk, sq)]
    jax_in = [jnp.asarray(a).astype(jdt) for a in arrs]
    torch_in = [torch.from_numpy(a.copy()).to(tdt) for a in arrs]
    return jax_in, torch_in


@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "b{}-sq{}-sk{}-h{}-d{}-{}".format(
                             *s[:5], "causal" if s[5] else "full"))
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
def test_flash_plain_matches_pallas_and_dense(shape, dt):
    _, jdt, tdt = dt
    causal = shape[5]
    scale = shape[4] ** -0.5
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(shape, jdt, tdt)

    # port: forward and backward through the autograd Function (CPU: plain)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = tflash.flash_attention(q, k, v, scale, causal)
    o.backward(do)
    _, lse = tflash.flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                    scale, causal)
    assert o.dtype == tdt and q.grad.dtype == tdt

    # the Pallas kernels in interpret mode, and their VJP
    def pallas(a, b_, c):
        return jflash.flash_attention(a, b_, c, scale, causal, 128, 128,
                                      True)

    po, vjp = jax.vjp(pallas, jq, jk, jv)
    pdq, pdk, pdv = vjp(jdo)
    _, (_, _, _, _, plse) = jflash._fwd(jq, jk, jv, scale, causal, 128, 128,
                                        True)
    # the XLA pair
    xo, res = jflash._dense_fwd(jq, jk, jv, scale, causal)
    xdq, xdk, xdv = jflash._dense_bwd(scale, causal, res, jdo)

    for want_o, want_lse, grads in ((po, plse, (pdq, pdk, pdv)),
                                    (xo, res[4], (xdq, xdk, xdv))):
        _close(o, want_o, tdt)
        _close(lse, np.asarray(want_lse)[..., 0], torch.float32)
        for got, want in zip((q.grad, k.grad, v.grad), grads):
            _close(got, want, tdt)


def test_gate_matches_the_reference():
    """The port's supports() is the reference's, head_dim gate included."""
    cases = []
    for sq, sk in ((128, 128), (256, 128), (128, 256), (100, 100),
                   (64, 64), (384, 384), (128, 200)):
        for d in (32, 64, 128, 200, 256, 288):
            for causal in (False, True):
                cases.append(((2, sq, 4, d), (2, sk, 4, d), None, 0.0,
                              causal))
    cases += [((1, 128, 2, 64), (1, 128, 2, 64), np.ones((1, 1, 128, 128)),
               0.0, False),
              ((1, 128, 2, 64), (1, 128, 2, 64), None, 0.1, True)]
    for qs, ks, mask, p, causal in cases:
        assert tflash.supports(qs, ks, mask, p, causal) == \
            jflash.supports(qs, ks, mask, p, causal), (qs, ks, causal)


def _sdpa_pair(shape, causal, seed=1):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(shape + (causal,), jnp.float32,
                                            torch.float32, seed)
    want = jops.scaled_dot_product_attention(jq, jk, jv, is_causal=causal)
    got = tops.scaled_dot_product_attention(q, k, v, is_causal=causal)
    return got, want


def test_sdpa_dispatch_takes_flash_where_the_reference_does(monkeypatch):
    calls = []
    real = tflash.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention", counted)
    # admitted: flash in both packages
    got, want = _sdpa_pair((1, 128, 128, 2, 32), True)
    assert len(calls) == 1
    _close(got, want, torch.float32)
    # s = 100 is rejected by both gates: the _sdpa_xla composition in both
    assert not tflash.supports((1, 100, 2, 32), (1, 100, 2, 32), None, 0.0,
                               True)
    got, want = _sdpa_pair((1, 100, 100, 2, 32), True)
    assert len(calls) == 1
    _close(got, want, torch.float32)
    (jq, jk, jv, _), _ = _inputs((1, 100, 100, 2, 32, True), jnp.float32,
                                 torch.float32, 1)
    _close(got, jops._sdpa_xla(jq, jk, jv, None, 0.0, True, True,
                               32 ** -0.5), torch.float32)
    # the flag switches flash off
    tflags.set_flags({"use_flash_attention": False})
    try:
        got, want = _sdpa_pair((1, 128, 128, 2, 32), True)
    finally:
        tflags.set_flags({"use_flash_attention": True})
    assert len(calls) == 1
    _close(got, want, torch.float32)


def test_flash_wrappers_check_their_inputs():
    q = torch.zeros(1, 128, 2, 300)
    with pytest.raises(ValueError, match="head_dim"):
        tflash._check(q, q, q)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tflash._check(q[..., :64].double(), q[..., :64].double(),
                      q[..., :64].double())
    tflash._check(*(q[..., :64].half().contiguous() for _ in range(3)))
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 128, 2, 192)[..., :64]
        tflash._check(x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        tflash.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"), 1.0,
                         False)


# ------------------------------------------------ dtypes and wide b * h
@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16"])
def test_every_admitted_dtype_has_a_kernel(name):
    """Every dtype amp's auto_cast admits (and the reference's gates, which
    have no dtype term) has a dtype code in the flash and paged wrappers,
    whose checks take it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.gpu import paged_attention as tpaged

    with amp.auto_cast(dtype=name):
        dt = amp.amp_state().dtype
    assert dt == getattr(torch, name)
    assert dt in tflash._DTYPES and dt in tpaged._DTYPES
    q = torch.zeros(1, 128, 2, 64, dtype=dt)
    tflash._check(q, q, q)
    pages = torch.zeros(3, 4, 2, 64, dtype=dt)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    cl = torch.ones(1, dtype=torch.int32)
    tpaged._check(q[:, 0], pages, pages, bt, cl, 1)
    tpaged._check(q[:, :3], pages, pages, bt, cl, 1)


@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "b{}-sq{}-sk{}-h{}-d{}-{}".format(
                             *s[:5], "causal" if s[5] else "full"))
def test_flash_fp16_plain_matches_pallas_and_dense(shape):
    """fp16 (what auto_cast(dtype="float16") feeds the kernels): the port's
    forward and gradients (CPU: the plain versions) against the Pallas
    kernels in interpret mode and the XLA pair in fp16, to one fp16
    rounding (2**-10) of the value and of the RMS."""
    causal = shape[5]
    scale = shape[4] ** -0.5
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(shape, jnp.float16,
                                               torch.float16)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = tflash.flash_attention(q, k, v, scale, causal)
    o.backward(do)
    assert o.dtype == torch.float16 and q.grad.dtype == torch.float16

    def pallas(a, b_, c):
        return jflash.flash_attention(a, b_, c, scale, causal, 128, 128,
                                      True)

    po, vjp = jax.vjp(pallas, jq, jk, jv)
    xo, res = jflash._dense_fwd(jq, jk, jv, scale, causal)
    for want_o, grads in ((po, vjp(jdo)),
                          (xo, jflash._dense_bwd(scale, causal, res, jdo))):
        _close(o, want_o, torch.float16)
        for got, want in zip((q.grad, k.grad, v.grad), grads):
            _close(got, want, torch.float16)


def test_flash_takes_any_b_times_h():
    """b * h past 65535 (grid.y's limit, which the kernels now continue on
    grid.z): the checks take b * h = 65,536, and the plain forward and
    backward agree with the reference's XLA pair there (fp32, b 16384, h
    4, s 2, d 8, causal)."""
    big = torch.zeros(65536, 1, 1, 8)
    tflash._check(big, big, big)
    shape = (16384, 2, 2, 4, 8, True)
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(shape, jnp.float32,
                                               torch.float32)
    scale = 8 ** -0.5
    o, lse = tflash.flash_fwd_plain(q, k, v, scale, True)
    delta = tflash.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, scale, True)
    dq = tflash.flash_dq_plain(*args)
    dk, dv = tflash.flash_dkv_plain(*args)
    xo, res = jflash._dense_fwd(jq, jk, jv, scale, True)
    xdq, xdk, xdv = jflash._dense_bwd(scale, True, res, jdo)
    _close(o, xo, torch.float32)
    _close(lse, np.asarray(res[4])[..., 0], torch.float32)
    for got, want in ((dq, xdq), (dk, xdk), (dv, xdv)):
        _close(got, want, torch.float32)


# ------------------------------------- the tensor-core kernels' arithmetic
# csrc/flash_attention.cu runs the bf16 forward and dK/dV on the tensor
# cores: q tiles of 64 rows, K/V tiles of 64 keys (32 for head_dim > 128) in
# the forward, q tiles of 32 rows (64 for head_dim <= 64) in dK/dV, an
# online softmax in fp32 in the log2 domain, fp32 accumulation, and P (dS)
# carried into its product as two bf16 terms, hi + lo. `_emulate_*` repeats
# that arithmetic in plain PyTorch, tile by tile, so the design is held to
# the reference's bound here before it runs on a card.
LOG2E = 1.4426950408889634


def _bf16_terms(x, terms):
    """x as the sum of `terms` bf16 values, each rounding what the ones
    before it missed (terms = 2: within 2**-16 of x, relative)."""
    out = torch.zeros_like(x)
    for _ in range(terms):
        out = out + (x - out).to(torch.bfloat16).float()
    return out


def _tiles(d):
    """(forward K/V tile, dK/dV q tile) of the kernel at this head_dim."""
    return (64 if d <= 128 else 32), (64 if d <= 64 else 32)


def _live(b, h, sq, sk, causal, seg_q=None, seg_k=None):
    """[b * h, sq, sk] bool: the pairs the kernels compute."""
    live = torch.ones(b, 1, sq, sk, dtype=torch.bool)
    if causal:
        live = live & torch.ones(sq, sk, dtype=torch.bool).tril()
    if seg_q is not None:
        live = live & (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
    return live.expand(b, h, sq, sk).reshape(b * h, sq, sk)


def _emulate_fwd(q, k, v, scale, causal, seg_q=None, seg_k=None, terms=2):
    """(o, lse) as the tensor-core forward computes them."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bk, _ = _tiles(d)
    qf, kf, vf = (tflash._heads_first(x) for x in (q, k, v))
    live = _live(b, h, sq, sk, causal, seg_q, seg_k)
    x = torch.bmm(qf, kf.transpose(1, 2)) * (scale * LOG2E)
    x = x.masked_fill(~live, tflash.NEG_INF)
    m = torch.full((b * h, sq), tflash.NEG_INF)
    l = torch.zeros(b * h, sq)
    acc = torch.zeros(b * h, sq, d)
    for k0 in range(0, sk, bk):
        xt, lt = x[:, :, k0:k0 + bk], live[:, :, k0:k0 + bk]
        mn = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.where(lt, torch.exp2(xt - mn[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.bmm(_bf16_terms(p, terms),
                                                 vf[:, k0:k0 + bk])
        m = mn
    l = l.clamp_min(1e-30)
    lse = torch.where(m == tflash.NEG_INF, m, m / LOG2E) + torch.log(l)
    return tflash._heads_last(acc / l[..., None], b, h, q.dtype), lse


def _emulate_dkv(q, k, v, dout, lse, delta, scale, causal, seg_q=None,
                 seg_k=None, terms=2):
    """(dk, dv) as the tensor-core dK/dV computes them."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _, bq = _tiles(d)
    qf, kf, vf, dof = (tflash._heads_first(x) for x in (q, k, v, dout))
    live = _live(b, h, sq, sk, causal, seg_q, seg_k)
    dk = torch.zeros(b * h, sk, d)
    dv = torch.zeros(b * h, sk, d)
    for q0 in range(0, sq, bq):
        sl = slice(q0, q0 + bq)
        x = torch.bmm(qf[:, sl], kf.transpose(1, 2)) * (scale * LOG2E)
        p = torch.where(live[:, sl],
                        torch.exp2(x - (lse[:, sl] * LOG2E)[..., None]), 0.0)
        dp = torch.bmm(dof[:, sl], vf.transpose(1, 2))
        ds = p * (dp - delta[:, sl, None])
        dv += torch.bmm(_bf16_terms(p, terms).transpose(1, 2), dof[:, sl])
        dk += torch.bmm(_bf16_terms(ds, terms).transpose(1, 2), qf[:, sl])
    return (tflash._heads_last(dk * scale, b, h, k.dtype),
            tflash._heads_last(dv, b, h, v.dtype))


def _dq_tile(d):
    """K/V tile of the tensor-core dQ at this head_dim."""
    return 64 if d <= 128 else 32


def _emulate_dq(q, k, v, dout, lse, delta, scale, causal, seg_q=None,
                seg_k=None, terms=2):
    """dq as the tensor-core dQ computes it: K/V tiles of 64 keys (32 at d
    256) against the whole q tile; P = exp2(S scale log2 e - lse log2 e) on
    the live pairs and 0 elsewhere (a dead row's exponent is +inf: P is
    set, not multiplied), dS = P (dP - delta) in fp32, dQ += dS K with dS as
    `terms` bf16 terms, times the scale at the end."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bk = _dq_tile(d)
    qf, kf, vf, dof = (tflash._heads_first(x) for x in (q, k, v, dout))
    live = _live(b, h, sq, sk, causal, seg_q, seg_k)
    l2 = (lse * LOG2E)[..., None]
    dq = torch.zeros(b * h, sq, d)
    for k0 in range(0, sk, bk):
        sl = slice(k0, k0 + bk)
        x = torch.bmm(qf, kf[:, sl].transpose(1, 2)) * (scale * LOG2E)
        p = torch.where(live[:, :, sl], torch.exp2(x - l2), 0.0)
        dp = torch.bmm(dof, vf[:, sl].transpose(1, 2))
        ds = p * (dp - delta[..., None])
        dq += torch.bmm(_bf16_terms(ds, terms), kf[:, sl])
    return tflash._heads_last(dq * scale, b, h, q.dtype)


@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "b{}-sq{}-sk{}-h{}-d{}-{}".format(
                             *s[:5], "causal" if s[5] else "full"))
def test_tensor_core_arithmetic_matches_pallas_and_dense(shape):
    """bf16: the emulated forward (o, lse) and dK/dV, from the emulated o
    and lse as the training step feeds them, against the Pallas kernels in
    interpret mode and the XLA pair, at the bf16 bound."""
    causal = shape[5]
    scale = shape[4] ** -0.5
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(shape, jnp.bfloat16,
                                               torch.bfloat16)
    o, lse = _emulate_fwd(q, k, v, scale, causal)
    delta = tflash.attention_delta(o, do)
    dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, causal)

    def pallas(a, b_, c):
        return jflash.flash_attention(a, b_, c, scale, causal, 128, 128,
                                      True)

    po, vjp = jax.vjp(pallas, jq, jk, jv)
    _, pdk, pdv = vjp(jdo)
    _, (_, _, _, _, plse) = jflash._fwd(jq, jk, jv, scale, causal, 128, 128,
                                        True)
    xo, res = jflash._dense_fwd(jq, jk, jv, scale, causal)
    _, xdk, xdv = jflash._dense_bwd(scale, causal, res, jdo)
    for want_o, want_lse, want_dk, want_dv in ((po, plse, pdk, pdv),
                                               (xo, res[4], xdk, xdv)):
        _close(o, want_o, torch.bfloat16)
        _close(lse, np.asarray(want_lse)[..., 0], torch.float32)
        _close(dk, want_dk, torch.bfloat16)
        _close(dv, want_dv, torch.bfloat16)


def _worst(got, want):
    """max |got - want| / (2**-7 (|want| + RMS(want))): the bf16 bound of
    _close, as a ratio (<= 1 passes)."""
    got, want = _np(got), _np(want)
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    return float((np.abs(got - want) / (2.0 ** -7 * (np.abs(want) + rms)))
                 .max())


def test_p_and_ds_need_two_bf16_terms():
    """Why P and dS enter their products as two bf16 terms: with one (P
    rounded to bf16 once, as FlashAttention-2 does), o, dQ, dK and dV miss
    the bf16 bound at b 1, s 1024, h 2, d 128, causal, against the fp32 plain
    versions; with two, all four outputs keep within it. (Rows that see
    few keys carry large, nearly cancelling terms: one rounding of each is
    larger than 2**-7 of the tensor's RMS.)"""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 1024, 2, 128)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))
    scale = 128 ** -0.5
    o_ref, lse = tflash.flash_fwd_plain(q, k, v, scale, True)
    delta = tflash.attention_delta(o_ref, do)
    dk_ref, dv_ref = tflash.flash_dkv_plain(q, k, v, do, lse, delta, scale,
                                            True)
    dq_ref = tflash.flash_dq_plain(q, k, v, do, lse, delta, scale, True)
    ratios = {}
    for terms in (1, 2):
        o, _ = _emulate_fwd(q, k, v, scale, True, terms=terms)
        dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, True,
                              terms=terms)
        dq = _emulate_dq(q, k, v, do, lse, delta, scale, True, terms=terms)
        ratios[terms] = [_worst(o, o_ref), _worst(dk, dk_ref),
                         _worst(dv, dv_ref), _worst(dq, dq_ref)]
    assert min(ratios[1]) > 1.0, ratios
    assert max(ratios[2]) <= 1.0, ratios


def test_tensor_core_arithmetic_segmented_dead_rows():
    """Segments with a -1 padding tail, ragged tiles (s 100) and query rows
    whose id no key carries: the emulated forward and dK/dV against the
    plain versions (which the Pallas kernels match, tests/test_torch_packed
    .py) at the bf16 bound; o of a dead row and dK/dV of a key no query
    sees are exactly 0."""
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 100, 2, 64
    seg_k = np.zeros((b, s), np.int32)
    seg_k[0, 30:70] = 1
    seg_k[0, 70:] = 2
    seg_k[1, 50:90] = 1
    seg_k[1, 90:] = -1
    seg_q = seg_k.copy()
    seg_q[0, 5] = seg_q[1, 99] = 7             # no key carries id 7
    seg_q[0, 72:] = 3                          # no query sees keys 72-99
    tq, tk = torch.from_numpy(seg_q), torch.from_numpy(seg_k)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))
    scale = d ** -0.5
    for causal in (False, True):
        o_ref, lse_ref = tflash.flash_seg_fwd_plain(q, k, v, tq, tk, scale,
                                                    causal)
        o, lse = _emulate_fwd(q, k, v, scale, causal, tq, tk)
        delta = tflash.attention_delta(o, do)
        dk_ref, dv_ref = tflash.flash_seg_dkv_plain(
            q, k, v, tq, tk, do, lse_ref, delta, scale, causal)
        dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, causal, tq,
                              tk)
        dead_q = torch.from_numpy(seg_q[:, :, None] != seg_k[:, None, :])
        dead_q = dead_q.all(-1)                       # [b, s]
        assert (o[dead_q] == 0).all()
        dead_k = torch.from_numpy(seg_q[:, None, :] != seg_k[:, :, None])
        dead_k = dead_k.all(-1)
        assert (dk[dead_k] == 0).all() and (dv[dead_k] == 0).all()
        live_rows = ~dead_q.repeat_interleave(h, 0).reshape(b * h, s)
        assert (lse[~live_rows] == lse_ref[~live_rows]).all()
        _close(lse[live_rows], lse_ref[live_rows], torch.float32)
        for got, want in ((o, o_ref), (dk, dk_ref), (dv, dv_ref)):
            _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES + [(1, 128, 128, 2, 256, True)],
                         ids=lambda s: "b{}-sq{}-sk{}-h{}-d{}-{}".format(
                             *s[:5], "causal" if s[5] else "full"))
def test_tensor_core_dq_matches_pallas_and_dense(shape):
    """bf16: the emulated tensor-core dQ, from the emulated forward's o and
    lse as the training step feeds it, against the Pallas dQ kernel (the
    VJP in interpret mode) and the XLA pair, at the bf16 bound; d 256 takes
    the kernel's 32-key tiles."""
    causal = shape[5]
    scale = shape[4] ** -0.5
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(shape, jnp.bfloat16,
                                               torch.bfloat16)
    o, lse = _emulate_fwd(q, k, v, scale, causal)
    delta = tflash.attention_delta(o, do)
    dq = _emulate_dq(q, k, v, do, lse, delta, scale, causal)

    def pallas(a, b_, c):
        return jflash.flash_attention(a, b_, c, scale, causal, 128, 128,
                                      True)

    _, vjp = jax.vjp(pallas, jq, jk, jv)
    xo, res = jflash._dense_fwd(jq, jk, jv, scale, causal)
    for want in (vjp(jdo)[0], jflash._dense_bwd(scale, causal, res, jdo)[0]):
        _close(dq, want, torch.bfloat16)


def test_tensor_core_dq_segmented_dead_rows():
    """The emulated tensor-core dQ with segments (a -1 padding tail, ragged
    key tiles at s 100, query rows whose id no key carries): within the
    bf16 bound of the plain version, and exactly 0 on the dead rows, in
    both causal modes."""
    rng = np.random.default_rng(12)
    b, s, h, d = 2, 100, 2, 64
    seg_k = np.zeros((b, s), np.int32)
    seg_k[0, 30:70] = 1
    seg_k[0, 70:] = 2
    seg_k[1, 50:90] = 1
    seg_k[1, 90:] = -1
    seg_q = seg_k.copy()
    seg_q[0, 5] = seg_q[1, 99] = 7             # no key carries id 7
    seg_q[1, 60:66] = 8
    tq, tk = torch.from_numpy(seg_q), torch.from_numpy(seg_k)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))
    scale = d ** -0.5
    dead = torch.from_numpy((seg_q[:, :, None] != seg_k[:, None, :])
                            .all(-1))
    assert int(dead.sum()) == 8
    for causal in (False, True):
        o, lse = tflash.flash_seg_fwd_plain(q, k, v, tq, tk, scale, causal)
        delta = tflash.attention_delta(o, do)
        want = tflash.flash_seg_dq_plain(q, k, v, tq, tk, do, lse, delta,
                                         scale, causal)
        dq = _emulate_dq(q, k, v, do, lse, delta, scale, causal, tq, tk)
        assert (dq[dead] == 0).all() and (want[dead] == 0).all()
        _close(dq, want, torch.bfloat16)


@pytest.mark.parametrize("name,group", [
    ("flash_fwd_mma_kernel<128, 64, 1, false>", "flash_fwd"),
    ("flash_fwd_mma_kernel<128, 64, 1, true>", "flash_seg_fwd"),
    ("flash_fwd_kernel<float, 128, 64, false>", "flash_fwd"),
    ("flash_dkv_mma_kernel<128, 32, 1, false>", "flash_dkv"),
    ("flash_dkv_mma_kernel<128, 32, 1, true>", "flash_seg_dkv"),
    ("flash_dkv_kernel<float, 128, 64, true>", "flash_seg_dkv"),
    ("flash_dq_kernel<__nv_bfloat16, 128, 64, true>", "flash_seg_dq"),
    ("flash_dq_mma_kernel<128, 64, 1, false>", "flash_dq"),
    ("flash_dq_mma_kernel<128, 64, 1, true>", "flash_seg_dq"),
    ("flash_fwd_kernel<__half, 128, 64, false>", "flash_fwd"),
])
def test_profile_attributes_both_template_families(name, group):
    """tools/profile_training.py puts the tensor-core and the CUDA-core
    templates, dense and segmented, under the same kernel (names as
    torch.profiler reports them)."""
    from paddle_tpu_torch.tools.profile_training import _group

    assert _group(f"void (anonymous namespace)::{name}(__nv_bfloat16 "
                  f"const*, int)") == group
