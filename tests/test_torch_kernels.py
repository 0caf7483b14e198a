"""The port's kernel modules against the JAX reference, on the CPU.

paddle_tpu_torch wraps each Hopper kernel with a plain PyTorch version that
runs for CPU tensors; these tests hold that plain version against the JAX
Pallas kernel it replaces (in interpret mode, as tests/test_pallas.py runs
it) and against the reference's XLA fallback, on the same numpy inputs.
The CUDA/Triton kernels themselves are held against the same plain versions
on the card by chip_smoke.py.

Tolerances: float32 compares to 1e-5 absolute (both sides do the same fp32
arithmetic, in a different summation order); bfloat16 compares to one or two
bf16 roundings of the output (2**-7 relative), since both sides round the
same fp32 result once, and the reference's XLA RMSNorm fallback rounds once
more (before the weight multiply), where the kernel and the port do not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import nn_ops as jops
from paddle_tpu.ops.pallas import fused_norm as jnorm
from paddle_tpu.ops.pallas import paged_attention as jpaged
from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.ops.gpu import fused_norm, paged_attention, rope

F32_TOL = 1e-5
BF16_REL = 2.0 ** -7   # one bf16 rounding, relative

DTYPES = [(np.float32, jnp.float32, torch.float32),
          ("bf16", jnp.bfloat16, torch.bfloat16)]


def _pair(a, jdt, tdt):
    """The same values as a JAX array and a torch tensor of one dtype."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tdt, roundings=1):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        tol = roundings * BF16_REL * np.maximum(np.abs(want), 1e-2)
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _rope_tables(P, d, theta=10000.0):
    inv = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float32) / d)
    f = np.outer(np.arange(P, dtype=np.float32), inv)
    emb = np.concatenate([f, f], -1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


# ---------------------------------------------------------------- RMSNorm
@pytest.mark.parametrize("shape", [(2, 7, 128), (300, 64)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_rms_norm_plain_matches_pallas_and_xla(shape, dt):
    _, jdt, tdt = dt
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jx, tx = _pair(x, jdt, tdt)
    jw, tw = _pair(w, jdt, tdt)
    got = fused_norm.fused_rms_norm(tx, tw, 1e-5)
    assert got.dtype == tdt and got.shape == tx.shape
    # the Pallas kernel: fp32 all the way, one final cast
    pallas = jnorm.fused_rms_norm(jx, jw, 1e-5, 256, True)
    _close(got, pallas, tdt)
    # the XLA fallback casts before the weight multiply: one more rounding
    xla = jops.rms_norm(jx, jw, 1e-5)
    _close(got, xla, tdt, roundings=2)
    if tdt == torch.bfloat16:
        # the port follows the kernel's formula, not the fallback's: it
        # equals the Pallas kernel bit for bit (up to rare fp32 summation-
        # order flips), where the fallback differs in ~1/4 of the elements
        assert (_np(got) != _np(pallas)).mean() <= 0.005
        assert (_np(got) != _np(xla)).mean() > 0.05
    # the op routes a 1-D weight through the kernel module
    _close(tops.rms_norm(tx, tw, 1e-5), got, tdt)


def _threads_per_row(vectors, per_thread=4):
    """csrc/fused_norm.cu threads_per_row: the fewest whole warps whose
    threads' 4 vectors each hold the row, at most 1024 threads."""
    warps = -(-(-(-vectors // per_thread)) // 32)
    return min(max(warps, 1) * 32, 1024)


def _emulate_rms_fwd(x, w, eps):
    """(y, rstd [n, 1]) as the CUDA forward kernel computes them: 16-byte
    vectors (one element on the scalar path) dealt to the row's threads,
    thread t taking vectors t, t + threads, ...; each thread's squares
    summed by FMA in vector then element order, then a warp's butterfly
    (xor 16, 8, 4, 2, 1), then the warps in order; y = (x * rstd) * w in
    fp32, cast once."""
    n, d = x.shape
    es = x.element_size()
    e = 16 // es if d * es % 16 == 0 and w.dtype == x.dtype else 1
    nv = d // e
    tpr = _threads_per_row(nv)
    xv = x.float().reshape(n, nv, e)
    ss = torch.zeros(n, tpr)
    for i in range(-(-nv // tpr)):
        idx = torch.arange(i * tpr, min((i + 1) * tpr, nv))
        for k in range(e):
            f = xv[:, idx, k].double()
            # an FMA rounds once: the product is exact in float64
            ss[:, :len(idx)] = (ss[:, :len(idx)].double() + f * f).float()
    lanes = ss.reshape(n, tpr // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ o]
    tot = torch.zeros(n)
    for k in range(tpr // 32):
        tot = tot + lanes[:, k, 0]
    rstd = torch.rsqrt(tot / d + eps)[:, None]
    y = (x.float() * rstd * w.float()).to(x.dtype)
    return y, rstd


# [8, 4096]: decode's rows (vector path, 128 threads bf16, 256 fp32);
# [8192, 64]: many short rows; d 90: the scalar path in every dtype
# (180 and 360 bytes are not whole 16-byte vectors)
@pytest.mark.parametrize("shape", [(8, 4096), (8192, 64), (300, 90)],
                         ids=["8x4096", "8192x64", "300x90-scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
def test_rms_forward_kernel_arithmetic_matches_pallas(shape, dtype):
    """The CUDA forward kernel's reduction order, emulated, against the
    Pallas forward kernel in interpret mode: y to one rounding of the
    output dtype (fp32: 1e-5), and the fp32 rstd the backward reads to
    1e-5 of its value."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    tw = torch.from_numpy(w).to(dtype)
    y, rstd = _emulate_rms_fwd(tx, tw, 1e-5)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    jy, (_, _, jrstd, _) = jnorm._run_fwd(
        jnp.asarray(tx.float().numpy(), jdt),
        jnp.asarray(tw.float().numpy(), jdt), 1e-5, 256, True)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-5)
    want = _np(jy)
    rel = {torch.float32: F32_TOL, torch.bfloat16: BF16_REL,
           torch.float16: 2.0 ** -10}[dtype]
    assert (np.abs(_np(y) - want) <= 1e-5 + rel * np.abs(want)).all()
    # the plain version the CPU wrapper takes agrees the same way
    py, prstd = fused_norm.rms_norm_fwd_plain(tx, tw, 1e-5)
    np.testing.assert_allclose(rstd.numpy(), prstd.numpy(), rtol=1e-5)
    assert (np.abs(_np(y) - _np(py)) <= 1e-5 + rel * np.abs(_np(py))).all()


def test_rms_norm_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the forward, the backward and the autograd path take
    the plain versions and launch nothing; a weight dtype the kernel has no
    code for is refused before any launch."""
    x = torch.randn(6, 40, dtype=torch.bfloat16)
    w = torch.ones(40, dtype=torch.bfloat16)
    before = (fused_norm.fused_rms_norm.launches,
              fused_norm.fused_rms_norm_bwd.launches)
    y, rstd = fused_norm.rms_norm_fwd(x, w, 1e-6)
    want_y, want_rstd = fused_norm.rms_norm_fwd_plain(x, w, 1e-6)
    assert torch.equal(y, want_y) and torch.equal(rstd, want_rstd)
    assert fused_norm.rms_norm_fwd(x, w, 1e-6, with_rstd=False)[1] is None
    xg = x.float().requires_grad_(True)
    fused_norm.fused_rms_norm(xg, w.float(), 1e-6).sum().backward()
    assert xg.grad is not None
    assert (fused_norm.fused_rms_norm.launches,
            fused_norm.fused_rms_norm_bwd.launches) == before
    with pytest.raises(TypeError):
        fused_norm._check(x, w.double())


# -------------------------------------------------------------------- RoPE
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_rope_plain_matches_pallas_and_xla(dt):
    _, jdt, tdt = dt
    rng = np.random.default_rng(1)
    b, s, h, hkv, d = 2, 8, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    cos, sin = _rope_tables(s + 5, d)
    cos, sin = cos[5:], sin[5:]        # a window that does not start at 0
    jq, tq = _pair(q, jdt, tdt)
    jk, tk = _pair(k, jdt, tdt)
    tq_o, tk_o = rope.fused_rope(tq, tk, torch.from_numpy(cos),
                                 torch.from_numpy(sin))
    jq_o, jk_o = jrope.fused_rope(jq, jk, jnp.asarray(cos), jnp.asarray(sin),
                                  interpret=True)
    _close(tq_o, jq_o, tdt)
    _close(tk_o, jk_o, tdt)
    _close(tq_o, jrope._apply_xla(jq, jnp.asarray(cos), jnp.asarray(sin),
                                  1.0), tdt)
    # the op takes [s, d] and [1, s, 1, d] tables through the kernel module
    oq, ok = tops.rotary_position_embedding(
        tq, tk, torch.from_numpy(cos)[None, :, None],
        torch.from_numpy(sin)[None, :, None])
    _close(oq, tq_o, tdt)
    _close(ok, tk_o, tdt)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_rope_packed_plain_matches_pallas_and_xla(dt):
    _, jdt, tdt = dt
    rng = np.random.default_rng(2)
    b, s, h, d, P = 2, 8, 4, 16, 24
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, 2, d)).astype(np.float32)
    cos, sin = _rope_tables(P, d)
    # row 0 runs past the table (P-1 = 23): the kernel clamps to the last row
    pos = np.stack([np.arange(20, 20 + s), rng.integers(0, P, s)])
    pos = pos.astype(np.int32)
    jq, tq = _pair(q, jdt, tdt)
    jk, tk = _pair(k, jdt, tdt)
    tc, ts, tp = (torch.from_numpy(cos), torch.from_numpy(sin),
                  torch.from_numpy(pos))
    tq_o, tk_o = rope.fused_rope_packed(tq, tk, tc, ts, tp)
    jq_o, jk_o = jrope.fused_rope_packed(jq, jk, jnp.asarray(cos),
                                         jnp.asarray(sin), jnp.asarray(pos),
                                         interpret=True)
    _close(tq_o, jq_o, tdt)
    _close(tk_o, jk_o, tdt)
    # the XLA fallback gathers with jnp.take, which fills NaN past the
    # table instead of clamping: compare it on the in-range row only
    jx = jrope._xla_packed(jq[1:], jnp.asarray(pos[1:]), jnp.asarray(cos),
                           jnp.asarray(sin), 1.0)
    _close(tq_o[1:], jx, tdt)
    oq, _ = tops.rotary_position_embedding_packed(tq, tk, tc, ts, tp)
    _close(oq, tq_o, tdt)


# --------------------------------------------------------- paged attention
def _paged_case(rng, slots=4, hq=4, hkv=2, d=16, bs=4, maxb=6):
    nb = slots * maxb + 1
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    q = rng.standard_normal((slots, hq, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb))
    bt = perm[:slots * maxb].reshape(slots, maxb).astype(np.int32)
    cl = np.array([maxb * bs, 5, 1, 13], np.int32)[:slots]
    # ragged: table entries past each context are null pages; the last slot
    # is idle (all-null table, context 1: it reads the null block)
    for r in range(slots):
        bt[r, -(-cl[r] // bs):] = 0
    bt[-1] = 0
    cl[-1] = 1
    return q, kp, vp, bt, cl


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_paged_attention_plain_matches_pallas_and_xla(dt):
    _, jdt, tdt = dt
    q, kp, vp, bt, cl = _paged_case(np.random.default_rng(3))
    jq, tq = _pair(q, jdt, tdt)
    jk, tk = _pair(kp, jdt, tdt)
    jv, tv = _pair(vp, jdt, tdt)
    got = paged_attention.paged_attention(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(cl))
    assert got.dtype == tdt and got.shape == tq.shape
    for splits in (1, 2):
        want = jpaged.paged_attention(jq, jk, jv, jnp.asarray(bt),
                                      jnp.asarray(cl), kv_splits=splits,
                                      interpret=True)
        _close(got, want, tdt)
    _close(got, jpaged.paged_attention_xla(jq, jk, jv, jnp.asarray(bt),
                                           jnp.asarray(cl)), tdt)


def test_paged_attention_rejects_what_the_kernel_does_not_take():
    q, kp, vp, bt, cl = _paged_case(np.random.default_rng(4))
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, cl)]
    # shape and dtype checks run before any launch (no card needed)
    with pytest.raises(ValueError):
        paged_attention._check(args[0][:, :3], *args[1:], 1)
    with pytest.raises(TypeError):
        paged_attention._check(*args[:3], args[3].long(), args[4], 1)
    with pytest.raises(ValueError):
        paged_attention._check(*args, 99)
    with pytest.raises(ValueError):
        paged_attention.paged_attention(*[a.to("meta") for a in args])


# every GQA group the reference's supports() admits, and what it refuses:
# (q_heads, kv_heads, d), g 16, 32 and MQA among them
GATE_CASES = [(32, 2, 128), (32, 1, 64), (64, 1, 256), (16, 16, 80),
              (64, 4, 128), (6, 4, 64), (32, 3, 128), (8, 2, 512),
              (32, 2, 264)]


@pytest.mark.parametrize("hq,hkv,d", GATE_CASES,
                         ids=lambda c: str(c))
def test_paged_wrappers_refuse_what_the_reference_refuses(hq, hkv, d):
    """Decode and the verify window take exactly the shapes the reference's
    supports() admits: any q_heads % kv_heads == 0 with d <= 256 (a decode
    step with g > 8 runs the verify kernel as a window of one token)."""
    pages = torch.zeros(3, 4, hkv, d)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    cl = torch.ones(1, dtype=torch.int32)
    admitted = jpaged.supports((1, hq, d), (3, 4, hkv, d))
    for q in (torch.zeros(1, hq, d), torch.zeros(1, 2, hq, d)):
        try:
            paged_attention._check(q, pages, pages, bt, cl, 1)
            took = True
        except ValueError:
            took = False
        assert took == admitted, (q.shape, admitted)


@pytest.mark.parametrize("hq,hkv", [(32, 2), (32, 1)], ids=["g16", "g32"])
def test_paged_decode_plain_matches_pallas_past_eight_rows(hq, hkv):
    """GQA groups of 16 and 32 (MQA): the plain decode against the Pallas
    decode kernel in interpret mode (1 and 2 splits) and the XLA fallback,
    fp32, and the split count the wrapper would choose there."""
    q, kp, vp, bt, cl = _paged_case(np.random.default_rng(6), hq=hq,
                                    hkv=hkv, d=16)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, cl)]
    got = paged_attention.paged_attention(*args)
    for splits in (1, 2):
        _close(got, jpaged.paged_attention(q, kp, vp, bt, cl,
                                           kv_splits=splits,
                                           interpret=True), torch.float32)
    _close(got, jpaged.paged_attention_xla(q, kp, vp, bt, cl), torch.float32)
    # a group past MAX_G takes the verify kernel's split choice (sq = 1)
    assert paged_attention.decode_splits(*args[:4], 132) == \
        paged_attention.verify_splits(args[0][:, None], *args[1:4], 132)


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_fp16_plain_matches_the_reference(kind):
    """fp16 q and pages (the dtype auto_cast(dtype="float16") gives): the
    plain decode and verify window against the Pallas kernels in interpret
    mode and the XLA fallbacks: both sides round the same fp32 value once,
    so to one fp16 ulp (2**-10 of the value) plus the fp32 slack, 1e-5."""
    rng = np.random.default_rng(9)
    q, kp, vp, bt, cl = _paged_case(rng, hq=8, hkv=2, d=16)
    if kind == "verify":
        q = rng.standard_normal((4, 3, 8, 16)).astype(np.float32)
        cl = np.maximum(cl - 3, 0).astype(np.int32)
    jq, jk, jv = (jnp.asarray(a, jnp.float16) for a in (q, kp, vp))
    tq, tk, tv = (torch.from_numpy(a).half() for a in (q, kp, vp))
    tb, tc = torch.from_numpy(bt), torch.from_numpy(cl)
    if kind == "decode":
        got = paged_attention.paged_attention(tq, tk, tv, tb, tc)
        wants = [jpaged.paged_attention(jq, jk, jv, bt, cl, interpret=True),
                 jpaged.paged_attention_xla(jq, jk, jv, bt, cl)]
    else:
        got = paged_attention.paged_attention_multi(tq, tk, tv, tb, tc)
        wants = [jpaged.paged_attention_multi(jq, jk, jv, bt, cl,
                                              interpret=True),
                 jpaged.paged_attention_xla_multi(jq, jk, jv, bt, cl)]
    assert got.dtype == torch.float16
    for want in wants:
        want = _np(want)
        assert (np.abs(_np(got) - want)
                <= 1e-5 + 2.0 ** -10 * np.abs(want)).all()
    paged_attention._check(tq, tk, tv, tb, tc, 1)   # a kernel dtype code


@pytest.mark.parametrize("slots,kv_heads,max_blocks,block_size,want", [
    (8, 32, 128, 16, 1),      # Llama-2-7B serving: 256 blocks fill 132 SMs
    (1, 32, 128, 16, 5),      # one slot: ceil(132 / 32)
    (64, 32, 128, 16, 1),     # enough (slot, head) blocks without splits
    (3, 8, 3, 16, 1),         # a table shorter than one run
    (2, 1, 4, 128, 4),        # four 128-token pages hold four runs
])
def test_kv_split_choice(slots, kv_heads, max_blocks, block_size, want):
    assert paged_attention.choose_kv_splits(
        slots, kv_heads, max_blocks, block_size, 132) == want


# ------------------------------------------------- cache-carrying attention
def test_paged_cached_attention_appends_and_attends_like_jax():
    rng = np.random.default_rng(5)
    q, kp, vp, bt, cl = _paged_case(rng)
    slots, hq, d = q.shape
    hkv = kp.shape[2]
    seq = cl - 1                            # tokens already cached
    q1 = q[:, None]
    k1 = rng.standard_normal((slots, 1, hkv, d)).astype(np.float32)
    v1 = rng.standard_normal((slots, 1, hkv, d)).astype(np.float32)
    jo, jk, jv = jops.paged_cached_attention(
        jnp.asarray(q1), jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(seq))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, tk2, tv2 = tops.paged_cached_attention(
        torch.from_numpy(q1), torch.from_numpy(k1), torch.from_numpy(v1),
        tk, tv, torch.from_numpy(bt), torch.from_numpy(seq))
    assert tk2 is tk and tv2 is tv          # pages updated in place
    _close(to, jo, torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a 2-token verify window on top: slot 0's second token runs past its
    # table into the null page, where the idle slot 3 writes too (which
    # write lands there is unspecified in both packages: page 0 and the
    # idle slot's output are garbage the engine ignores)
    q2, k2, v2 = (rng.standard_normal((slots, 2, h, d)).astype(np.float32)
                  for h in (hq, hkv, hkv))
    jo, jk, jv = jops.paged_cached_attention(
        jnp.asarray(q2), jnp.asarray(k2), jnp.asarray(v2), jk, jv,
        jnp.asarray(bt), jnp.asarray(seq))
    to, _, _ = tops.paged_cached_attention(
        torch.from_numpy(q2), torch.from_numpy(k2), torch.from_numpy(v2),
        tk, tv, torch.from_numpy(bt), torch.from_numpy(seq))
    _close(to[:3], np.asarray(jo)[:3], torch.float32)
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


def _cma_inputs(rng, b, sq, max_len, hq=4, hkv=2, d=8):
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    kc = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    return q, k, v, kc, vc


@pytest.mark.parametrize("pos", [
    0, 5,
    # pos + sq runs past max_len: the write start clamps to max_len - sq
    # (lax.dynamic_update_slice) while the mask keeps the unclamped pos
    11,
    # per-row offsets; row 1's last positions fall past max_len and are
    # dropped (JAX scatter semantics)
    np.array([0, 12, 3], np.int32)],
    ids=["scalar0", "scalar5", "scalar_clamped", "per_row_dropped"])
def test_cached_multihead_attention_matches_jax(pos):
    rng = np.random.default_rng(6)
    b, sq, max_len = 3, 4, 14
    q, k, v, kc, vc = _cma_inputs(rng, b, sq, max_len)
    jo, jk, jv = jops.cached_multihead_attention(
        *[jnp.asarray(a) for a in (q, k, v, kc, vc)], jnp.asarray(pos))
    tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk2, tv2 = tops.cached_multihead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tk, tv, tpos)
    assert tk2 is tk and tv2 is tv
    _close(to, jo, torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sdpa_causal_is_aligned_bottom_right():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    want = jops._sdpa_xla(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                          None, 0.0, True, False, 8 ** -0.5)
    got = tops.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
        is_causal=True)
    _close(got, want, torch.float32)
