"""The paged decode kernel's arithmetic (csrc/paged_attention.cu
paged_decode_ring_kernel), emulated on the CPU, against the JAX Pallas
decode kernel in interpret mode and the port's plain version.

The kernel cannot run here (no card, no nvcc); `_emulate_decode` repeats
its walk in PyTorch: each (slot, kv head) block cuts the slot's live
context into `splits` runs of whole tiles (a tile is 4 KB of K rows: 16
tokens of a bf16 or fp16 d-128 row, 8 of an fp32 one), its four warps take
the tiles w, w + 4, ... of the run, each warp keeps its own (m, l, O) with
an online softmax in the log2 domain over U passes of the tile at a time
(positions past the run masked, exactly 0 in P), the warps merge by their
maxima, and the splits combine by logsumexp weighting. chip_smoke.py holds
the kernel itself against the plain version on the card.

Bounds, as chip_smoke.py's: fp32 1e-5 (1 + |value|), the same fp32
arithmetic in another order; bf16 one bf16 ulp (1e-5 + 2**-7 |value|) and
fp16 one fp16 ulp (1e-5 + 2**-10 |value|), since both sides round an fp32
value once. A slot with context 0 gets zeros from the kernel and from the
Pallas kernel (the plain version's mean of V is not compared there).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpaged
from paddle_tpu_torch.ops import gpu
from paddle_tpu_torch.ops.gpu import paged_attention as pa

LOG2E = 1.4426950408889634
RING_TILE_BYTES = 4096          # csrc/paged_attention.cu kRingTileBytes
WARPS = 4
BOUNDS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7),
          torch.float16: (1e-5, 2.0 ** -10)}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float16: jnp.float16}


def _geometry(d, itemsize, g):
    """(tokens a tile, tokens a softmax update) of the kernel's
    instantiation for head_dim d and group g: D the smallest of 64, 128,
    256 holding d; 16-byte chunks, LPT lanes a token, TPP tokens a pass,
    NP passes a tile; G the smallest of 1, 2, 4, 8 holding g updates over
    half a tile for G > 2."""
    D = 64 if d <= 64 else 128 if d <= 128 else 256
    lpt = min(D * itemsize // 16, 32)
    tok = RING_TILE_BYTES // (D * itemsize)
    tpp = 32 // lpt
    np_ = tok // tpp
    big_g = 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8
    u = np_ // 2 if big_g > 2 and np_ % 2 == 0 else np_
    return tok, u * tpp


def _emulate_decode(q, kp, vp, bt, cl, splits):
    """[slots, hq, d] in q's dtype as the decode kernel computes it."""
    slots, hq, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    g, maxb = hq // hkv, bt.shape[1]
    span = maxb * bs
    tok, upd = _geometry(d, q.element_size(), g)
    sl2 = d ** -0.5 * LOG2E
    out = torch.zeros(slots, hq, d)
    for s in range(slots):
        ctx = max(0, min(int(cl[s]), span))
        k = kp[bt[s].long()].reshape(span, hkv, d).float()
        v = vp[bt[s].long()].reshape(span, hkv, d).float()
        per = -(-(-(-ctx // tok)) // splits)
        for h in range(hkv):
            qf = q[s, h * g:(h + 1) * g].float() * sl2
            parts = []
            for sp in range(splits):
                tb = sp * per * tok
                te = min(ctx, tb + per * tok)
                nt = -(-(te - tb) // tok) if te > tb else 0
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), pa.NEG_INF)
                    l = torch.zeros(g)
                    acc = torch.zeros(g, d)
                    for i in range(w, nt, WARPS):
                        for u0 in range(tb + i * tok, tb + (i + 1) * tok,
                                        upd):
                            pos = torch.arange(u0, u0 + upd)
                            live = pos < te
                            rows = pos.clamp(max=span - 1)
                            x = torch.where(live, qf @ k[rows, h].T,
                                            pa.NEG_INF)
                            mn = torch.maximum(m, x.amax(-1))
                            alpha = torch.exp2(m - mn)
                            p = torch.where(live, torch.exp2(x - mn[:, None]),
                                            0.0)
                            l = l * alpha + p.sum(-1)
                            acc = acc * alpha[:, None] + p @ v[rows, h]
                            m = mn
                    warps.append((m, l, acc))
                mw = torch.stack([wm for wm, _, _ in warps]).amax(0)
                wts = [torch.exp2(wm - mw) for wm, _, _ in warps]
                num = sum(wa * wt[:, None] for (_, _, wa), wt in zip(warps,
                                                                     wts))
                den = sum(wl * wt for (_, wl, _), wt in zip(warps, wts))
                m_nat = torch.where(mw == pa.NEG_INF, pa.NEG_INF,
                                    mw * math.log(2.0))
                parts.append((m_nat, den, num))
            if splits == 1:
                _, den, num = parts[0]
            else:       # paged_combine_kernel, natural log
                mg = torch.stack([pm for pm, _, _ in parts]).amax(0)
                wts = [torch.exp(pm - mg) for pm, _, _ in parts]
                num = sum(pn * wt[:, None] for (_, _, pn), wt in zip(parts,
                                                                     wts))
                den = sum(pl * wt for (_, pl, _), wt in zip(parts, wts))
            out[s, h * g:(h + 1) * g] = num / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


# contexts 0, 1, 16 (one bf16 d-128 tile), 17 and a long one; the long
# slot's table holds 19 pages of 16, the others null pages past their
# context
CONTEXTS = [0, 1, 16, 17, 300]


def _decode_case(g, d, dtype, seed, hkv=2, bs=16):
    rng = np.random.default_rng(seed)
    slots = len(CONTEXTS)
    maxb = -(-max(CONTEXTS) // bs)
    nb = slots * maxb + 1
    q = rng.standard_normal((slots, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    bt = (rng.permutation(nb - 1)[:slots * maxb] + 1).reshape(
        slots, maxb).astype(np.int32)
    for r, c in enumerate(CONTEXTS):
        bt[r, -(-c // bs):] = 0
    cl = np.asarray(CONTEXTS, np.int32)
    # the values as the dtype holds them, for both packages
    q, kp, vp = (torch.from_numpy(a).to(dtype) for a in (q, kp, vp))
    return q, kp, vp, torch.from_numpy(bt), torch.from_numpy(cl)


def _within(got, want, bound):
    atol, rtol = bound
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("g,d", [(1, 128), (4, 64), (8, 32)],
                         ids=["g1-d128", "g4-d64", "g8-d32"])
@pytest.mark.parametrize("splits", [1, 2, 5])
def test_decode_kernel_arithmetic_matches_pallas_and_plain(dtype, g, d,
                                                           splits):
    """The emulated decode kernel against the Pallas decode kernel in
    interpret mode (the same splits) and the plain version, within one ulp
    of the dtype (fp32: 1e-5 of 1 + |value|). Five splits is more than the
    short slots have tiles: those splits walk nothing."""
    q, kp, vp, bt, cl = _decode_case(g, d, dtype, seed=10 * g + splits)
    got = _emulate_decode(q, kp, vp, bt, cl, splits)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    assert (got[0] == 0).all()                      # context 0: zeros
    jdt = JAX_DTYPES[dtype]
    kern = jpaged.paged_attention(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (q, kp, vp)),
        jnp.asarray(bt.numpy()), jnp.asarray(cl.numpy()), kv_splits=splits,
        interpret=True)
    kern = torch.from_numpy(np.array(kern.astype(jnp.float32)))
    assert _within(got, kern, BOUNDS[dtype])
    plain = pa.paged_attention_plain(q, kp, vp, bt, cl)
    assert _within(got[1:], plain[1:], BOUNDS[dtype])


def test_decode_tiles_follow_the_row_bytes():
    """A tile is 4 KB of K rows whichever the dtype and head_dim: 16 tokens
    of a bf16 d-128 row (the main path), 8 of fp32, 32 of bf16 d 64, 4 of
    fp32 d 256; groups past 2 rows update the softmax every half tile."""
    assert _geometry(128, 2, 1) == (16, 16)
    assert _geometry(128, 4, 1) == (8, 8)
    assert _geometry(64, 2, 8) == (32, 16)
    assert _geometry(256, 4, 4) == (4, 2)
    assert _geometry(80, 2, 3) == (16, 8)


def test_decode_route_follows_the_vector_rule():
    """`route` sends a decode step to the decode kernel where g <= 8, its
    rows are whole 16-byte vectors and q and the pages are aligned. Every
    other step takes the verify kernel and its split choice as a window of
    one token."""
    def pages(hkv, d, dtype, offset=0):
        n = 5 * 16 * hkv * d
        return torch.zeros(n + offset, dtype=dtype)[offset:].view(
            5, 16, hkv, d)

    bt = torch.zeros(3, 4, dtype=torch.int32)
    for hq, hkv, d, dtype, offset, want in (
            (32, 32, 128, torch.bfloat16, 0, True),
            (32, 4, 128, torch.float16, 0, True),
            (16, 2, 64, torch.float32, 0, True),
            (32, 2, 128, torch.bfloat16, 0, False),     # g 16
            (8, 8, 36, torch.bfloat16, 0, False),       # 72-byte rows
            (8, 8, 36, torch.float32, 0, True),         # 144-byte rows
            (8, 2, 64, torch.bfloat16, 1, False)):      # off alignment
        q = torch.zeros(3 * hq * d + offset, dtype=dtype)[offset:].view(
            3, hq, d)
        kp = pages(hkv, d, dtype, offset)
        assert (pa.route(q, kp, kp) == pa.DECODE) == want, \
            (hq, hkv, d, dtype, offset)
        chosen = pa.decode_splits(q, kp, kp, bt, 132)
        if want:
            assert chosen == pa.choose_kv_splits(3, hkv, 4, 16, 132)
        else:
            assert chosen == pa.verify_splits(q[:, None], kp, kp, bt, 132)


def test_decode_wrapper_takes_the_plain_version_on_cpu():
    q, kp, vp, bt, cl = _decode_case(4, 64, torch.bfloat16, seed=3)
    before = dict(gpu.launch_counts())
    got = pa.paged_attention(q, kp, vp, bt, cl)
    assert torch.equal(got, pa.paged_attention_plain(q, kp, vp, bt, cl))
    assert gpu.launch_counts() == before                # no kernel
    assert gpu.KERNEL_WRAPPERS["paged_decode"] is pa.paged_attention
