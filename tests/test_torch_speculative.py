"""The port's self-speculative serving path against the JAX reference, on
the CPU: the verify window's plain attention and cache op, the n-gram
drafter and its throttle, the allocator's append and rollback, the GPT's
cached forwards, and whole engines (tiny Llama and tiny GPT, spec on and
off, prefix cache on and off).

Inputs and weights are made with numpy from a seed and handed to both
packages. The weights of the engine tests are N(0, 0.05) with norms at 1
and biases at 0: at that scale the tiny models' greedy streams repeat with
changes, so drafts are accepted AND rejected (measured: both happen in the
workload below). The zero-weight models emit token 0 forever, a stream that
drafts perfectly.

Tolerances: the plain verify attention and the window op agree with the
reference's Pallas kernel (interpret mode) and XLA fallback to 2e-5
(fp32 sums in another order); pages after the window write agree exactly
(the same values copied); GPT logits to 1e-4 (fp32 matmuls in another
order over logits of magnitude ~5); token streams, drafts, throttle state,
allocator state and speculation counters agree exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.kernels import nn_ops as jax_nn_ops
from paddle_tpu.ops.pallas import paged_attention as jax_pa
from paddle_tpu.serving import BlockAllocator as JaxAllocator
from paddle_tpu.serving import NgramDrafter as JaxDrafter
from paddle_tpu.serving import PagedLayerCache as JaxPagedCache
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import SpecState as JaxSpecState
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_jax_state_dict)
from paddle_tpu_torch.models.generation import init_kv_cache
from paddle_tpu_torch.observability.registry import REGISTRY
from paddle_tpu_torch.ops import gpu, nn_ops
from paddle_tpu_torch.ops.gpu import paged_attention as pa
from paddle_tpu_torch.serving import (BlockAllocator, NgramDrafter,
                                      PagedLayerCache, ServingEngine,
                                      SpecState)

ATOL = 2e-5


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------- plain verify attention
def _window_case(slots, sq, hq, hkv, d, bs, bases, seed, max_blocks=None):
    """Pages, a permuted block table (null past each window) and base
    lengths; max_blocks narrower than the windows makes them overflow."""
    rng = np.random.default_rng(seed)
    maxb = max_blocks or -(-(max(bases) + sq) // bs)
    nb = slots * maxb + 1
    q = rng.standard_normal((slots, sq, hq, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    bt = (rng.permutation(nb - 1)[:slots * maxb] + 1).reshape(
        slots, maxb).astype(np.int32)
    for r, c in enumerate(bases):
        bt[r, -(-(c + sq) // bs):] = 0
    return q, kp, vp, bt, np.asarray(bases, np.int32)


# (slots, sq, hq, hkv, d, bs, bases): MHA and GQA, sq 1-9, windows that
# start on, end on and cross block boundaries
WINDOWS = [
    (3, 4, 4, 4, 8, 4, [12, 1, 6]),
    (3, 5, 8, 2, 16, 4, [3, 8, 0]),
    (2, 9, 8, 1, 8, 8, [7, 16]),
    (2, 1, 4, 2, 8, 4, [4, 9]),
    (4, 2, 6, 3, 8, 4, [0, 5, 11, 15]),
]


@pytest.mark.parametrize("case", WINDOWS, ids=lambda c: f"sq{c[1]}")
def test_plain_verify_matches_pallas_and_xla(case):
    *geo, bases = case
    q, kp, vp, bt, cl = _window_case(*geo, bases, seed=len(bases))
    got = pa.paged_attention_multi_plain(*_t(q, kp, vp, bt, cl)).numpy()
    want = np.asarray(jax_pa.paged_attention_xla_multi(q, kp, vp, bt, cl))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    for splits in (1, 2):
        kern = np.asarray(jax_pa.paged_attention_multi(
            q, kp, vp, bt, cl, kv_splits=splits, interpret=True))
        np.testing.assert_allclose(got, kern, atol=ATOL, rtol=ATOL)


def test_sq1_window_equals_decode_at_base_plus_one():
    q, kp, vp, bt, cl = _window_case(3, 1, 8, 2, 16, 4, [0, 7, 8], seed=9)
    win = pa.paged_attention_multi(*_t(q, kp, vp, bt, cl))[:, 0]
    dec = pa.paged_attention(*_t(q[:, 0], kp, vp, bt, cl + 1))
    np.testing.assert_allclose(win.numpy(), dec.numpy(), atol=ATOL,
                               rtol=ATOL)


# The bf16 verify window on the tensor cores (csrc/paged_attention.cu
# paged_verify_mma_kernel): blocks of 16 (query, head) rows of one kv head,
# the run of a split cut into 16-token tiles dealt to four warps in turn,
# an online softmax per warp in the log2 domain with the per-row limit,
# P entering P V as `terms` bf16 terms, then the warps and the splits
# merged by their maxima. `_emulate_verify` repeats that arithmetic.
LOG2E = 1.4426950408889634
BF16_ULP = (1e-5, 2.0 ** -7)    # atol, rtol: chip_smoke.py's verify bound


def _emulate_verify(q, kp, vp, bt, cl, splits=1, terms=2):
    """Output [slots, sq, hq, d] in q's dtype as the tensor-core verify
    kernel computes it from q and the pages (bf16)."""
    from test_torch_flash import _bf16_terms

    slots, sq, hq, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    g, maxb = hq // hkv, bt.shape[1]
    rows, sl2 = sq * g, d ** -0.5 * LOG2E
    out = torch.zeros(slots, sq, hq, d)
    for s in range(slots):
        base = int(cl[s])
        k = kp[bt[s].long()].reshape(maxb * bs, hkv, d).float()
        v = vp[bt[s].long()].reshape(maxb * bs, hkv, d).float()
        for h in range(hkv):
            for row0 in range(0, rows, 16):
                r = torch.arange(row0, min(row0 + 16, rows))
                qi, head = r // g, h * g + r % g
                qf = q[s, qi, head].float()
                lim = base + qi + 1
                ctx = min(base + int(qi[-1]) + 1, maxb * bs)
                per = -(-(-(-ctx // 16)) // splits)
                parts = []
                for sp in range(splits):
                    tb = sp * per * 16
                    te = min(ctx, tb + per * 16)
                    nt = -(-(te - tb) // 16) if te > tb else 0
                    for w in range(4):
                        m = torch.full((len(r),), pa.NEG_INF)
                        l = torch.zeros(len(r))
                        acc = torch.zeros(len(r), d)
                        for i in range(w, nt, 4):
                            pos = torch.arange(tb + i * 16, tb + i * 16 + 16)
                            live = ((pos[None] < lim[:, None])
                                    & (pos[None] < te))
                            kt = k[pos.clamp(max=maxb * bs - 1), h]
                            vt = v[pos.clamp(max=maxb * bs - 1), h]
                            x = (qf @ kt.T) * sl2
                            x = torch.where(live, x, pa.NEG_INF)
                            mn = torch.maximum(m, x.amax(-1))
                            alpha = torch.exp2(m - mn)
                            p = torch.where(live, torch.exp2(x - mn[:, None]),
                                            0.0)
                            l = l * alpha + p.sum(-1)
                            acc = (acc * alpha[:, None]
                                   + _bf16_terms(p, terms) @ vt)
                            m = mn
                        parts.append((m, l, acc))
                mg = torch.stack([pm for pm, _, _ in parts]).amax(0)
                num = sum(pa * torch.exp2(pm - mg)[:, None]
                          for pm, _, pa in parts)
                den = sum(pl_ * torch.exp2(pm - mg) for pm, pl_, _ in parts)
                out[s, qi, head] = num / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _bf16_window(slots, sq, hq, hkv, d, bs, bases, seed):
    """_window_case's arrays with q and the pages rounded to bf16 (as
    float32 for the reference, bf16 for the port)."""
    q, kp, vp, bt, cl = _window_case(slots, sq, hq, hkv, d, bs, bases, seed)
    q, kp, vp = (np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
                 for a in (q, kp, vp))
    return q, kp, vp, bt, cl


def _within(got, want, bound):
    atol, rtol = bound
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return bool((np.abs(got - want) <= atol + rtol * np.abs(want)).all())


# (slots, sq, hq, hkv, d, bs, bases): the spec slice's window (W = 5, g =
# 1) at a small width, and a GQA window of 72 rows (hq 32 over 4 kv heads,
# sq 9: five row tiles, the last one ragged)
TC_WINDOWS = [(3, 5, 4, 4, 32, 16, [300, 17, 90]),
              (2, 9, 32, 4, 16, 16, [77, 5])]


@pytest.mark.parametrize("case", TC_WINDOWS, ids=["w5-g1", "sq9-gqa"])
@pytest.mark.parametrize("splits", [1, 2])
def test_tensor_core_verify_arithmetic_matches_pallas_and_plain(case,
                                                                 splits):
    """bf16: the emulated tensor-core verify window against the Pallas
    verify kernel in interpret mode (bf16 in, fp32 arithmetic, bf16 out)
    and the plain version, within one bf16 ulp (chip_smoke.py's bound)."""
    *geo, bases = case
    q, kp, vp, bt, cl = _bf16_window(*geo, bases, seed=20 + len(bases))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, kp, vp))
    tbt, tcl = _t(bt, cl)
    got = _emulate_verify(tq, tk, tv, tbt, tcl, splits)
    want = pa.paged_attention_multi_plain(tq, tk, tv, tbt, tcl)
    assert _within(got, want.float(), BF16_ULP)
    kern = jax_pa.paged_attention_multi(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), bt, cl, kv_splits=splits,
        interpret=True)
    assert _within(got, np.asarray(kern.astype(jnp.float32)), BF16_ULP)


def test_verify_p_needs_two_bf16_terms():
    """Why P enters P V as two bf16 terms: with one rounding, the emulated
    window at the spec slice's width (W = 5, d 128, a 2,043-token base
    among short ones) misses chip_smoke.py's one-ulp bound against the
    plain version; with two it keeps within it."""
    q, kp, vp, bt, cl = _bf16_window(3, 5, 2, 2, 128, 16, [2043, 12, 300],
                                     seed=31)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, kp, vp))
    tbt, tcl = _t(bt, cl)
    want = pa.paged_attention_multi_plain(tq, tk, tv, tbt, tcl).float()
    ok = {t: _within(_emulate_verify(tq, tk, tv, tbt, tcl, terms=t), want,
                     BF16_ULP) for t in (1, 2)}
    assert ok == {1: False, 2: True}, ok


def test_verify_wrapper_takes_the_plain_version_on_cpu():
    q, kp, vp, bt, cl = _window_case(2, 3, 4, 2, 8, 4, [5, 2], seed=4)
    before = pa.paged_attention_multi.launches
    got = pa.paged_attention_multi(*_t(q, kp, vp, bt, cl))
    want = pa.paged_attention_multi_plain(*_t(q, kp, vp, bt, cl))
    assert torch.equal(got, want)
    assert pa.paged_attention_multi.launches == before      # no kernel
    assert gpu.KERNEL_WRAPPERS["paged_verify"] is pa.paged_attention_multi
    assert "paged_verify" in gpu.launch_counts()
    # the split count the wrapper would choose counts the grid's row tiles
    assert pa.row_tiles(5, 1) == 1 and pa.row_tiles(9, 8) == 9
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_attention_multi(torch.empty(2, 3, 4, 8, device="meta"),
                                 *_t(kp, vp, bt, cl))


def test_kernel_shape_gate_is_the_references():
    """The verify and decode kernels take any sq * g: the wrapper raises
    only where the reference's supports() refuses (d > 256, q_heads %
    kv_heads)."""
    def check(sq, hq, hkv, d):
        q = torch.zeros(1, sq, hq, d)
        kp = torch.zeros(3, 4, hkv, d)
        bt = torch.zeros(1, 2, dtype=torch.int32)
        cl = torch.zeros(1, dtype=torch.int32)
        pa._check(q, kp, kp, bt, cl, 1)

    check(9, 64, 4, 128)                         # 144 rows, g = 16
    assert jax_pa.supports((1, 64, 128), (3, 4, 4, 128))
    for bad in ((2, 6, 4, 64), (2, 4, 4, 512)):
        assert not jax_pa.supports((1, bad[1], bad[3]),
                                   (3, 4, bad[2], bad[3]))
        with pytest.raises(ValueError):
            check(*bad)
    pages = torch.zeros(3, 4, 1, 8)
    # decode takes any group too (g > 8 runs the verify kernel)
    pa._check(torch.zeros(1, 16, 8), pages, pages,
              torch.zeros(1, 2, dtype=torch.int32),
              torch.zeros(1, dtype=torch.int32), 1)


# ------------------------------------------------ the window's cache op
def _write_case(seed, slots=3, sq=4, hq=4, hkv=2, d=8, bs=4, maxb=3):
    rng = np.random.default_rng(seed)
    nb = slots * maxb + 1
    q = rng.standard_normal((slots, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((slots, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((slots, sq, hkv, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    bt = np.arange(1, nb, dtype=np.int32).reshape(slots, maxb)
    return q, k, v, kp, vp, bt


@pytest.mark.parametrize("lens", [[2, 5, 0], [3, 7, 10]],
                         ids=["inside", "overflow"])
def test_window_cache_op_matches_the_reference(lens):
    """Pages after the write and the outputs. With lens [3, 7, 10] the third
    slot's window (positions 10..13 of a 12-position table) spills two
    tokens into the null page 0, the only slot that reaches it."""
    q, k, v, kp, vp, bt = _write_case(seed=sum(lens))
    lens = np.asarray(lens, np.int32)
    out_j, kp_j, vp_j = jax_nn_ops.paged_cached_attention(
        q, k, v, jnp.asarray(kp), jnp.asarray(vp), bt, lens)
    tq, tk, tv, tkp, tvp, tbt, tl = _t(q, k, v, kp, vp, bt, lens)
    out, kp2, vp2 = nn_ops.paged_cached_attention(tq, tk, tv, tkp, tvp, tbt,
                                                  tl)
    assert kp2 is tkp and vp2 is tvp                 # written in place
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(kp_j))
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(vp_j))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=ATOL)
    if lens[2] == 10:
        # positions 12, 13 went to the null page, not onto the last block
        np.testing.assert_array_equal(kp2[0, :2].numpy(), k[2, 2:])
        np.testing.assert_array_equal(kp2[bt[2, -1], 2:].numpy(), k[2, :2])


def test_window_equals_sequential_single_token_steps():
    q, k, v, kp, vp, bt = _write_case(seed=11, slots=2, maxb=4)
    lens = np.array([3, 7], np.int32)                # crosses a boundary
    tq, tk, tv, kw, vw, tbt, tl = _t(q, k, v, kp, vp, bt, lens)
    out_w, _, _ = nn_ops.paged_cached_attention(tq, tk, tv, kw, vw, tbt, tl)
    ks, vs = _t(kp, vp)
    outs = []
    for i in range(q.shape[1]):
        o, ks, vs = nn_ops.paged_cached_attention(
            tq[:, i:i + 1], tk[:, i:i + 1], tv[:, i:i + 1], ks, vs, tbt,
            tl + i)
        outs.append(o)
    assert torch.equal(kw, ks) and torch.equal(vw, vs)
    np.testing.assert_allclose(out_w.numpy(), torch.cat(outs, 1).numpy(),
                               atol=ATOL, rtol=ATOL)


# --------------------------------------------------- drafter and throttle
def _histories(seed, n=12):
    """Seeded histories: periodic with noise, constant tails, random."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        period = int(rng.integers(1, 6))
        base = [int(t) for t in rng.integers(0, 9, period)]
        h = (base * 40)[:int(rng.integers(3, 60))]
        for _ in range(int(rng.integers(0, 4))):
            h[int(rng.integers(0, len(h)))] = int(rng.integers(0, 9))
        out.append(h if i % 4 else [int(t) for t in rng.integers(0, 5, 30)])
    return out


@pytest.mark.parametrize("max_n,min_n", [(3, 2), (4, 1), (2, 2)])
def test_ngram_drafter_matches_the_reference(max_n, min_n):
    for hist in _histories(max_n * 10 + min_n):
        ours, ref = NgramDrafter(max_n, min_n), JaxDrafter(max_n, min_n)
        # grow the history as the engine does, proposing at every length
        for t in range(1, len(hist) + 1):
            k = 1 + t % 6
            assert ours.propose(hist[:t], k) == ref.propose(hist[:t], k)
            assert ours._upto == ref._upto
        assert ours._index == ref._index
    with pytest.raises(ValueError):
        NgramDrafter(min_n=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_state_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    k_max, pause = int(rng.integers(1, 9)), int(rng.integers(1, 20))
    miss = int(rng.integers(1, 5))
    ours = SpecState(k_max, pause_ticks=pause, miss_limit=miss)
    ref = JaxSpecState(k_max, pause_ticks=pause, miss_limit=miss)
    names = ("serving_spec_proposed_total", "serving_spec_accepted_total",
             "serving_spec_rollbacks_total")
    counters = [REGISTRY.counter(n) for n in names]
    before = [c.value() for c in counters]
    for tick in range(300):
        dk = ours.draft_k(tick)
        assert dk == ref.draft_k(tick)
        if dk == 0:
            continue
        proposed = int(rng.integers(0, dk + 1))
        accepted = int(rng.integers(0, proposed + 1)) if rng.random() < .5 \
            else 0
        ours.record(proposed, accepted, tick)
        ref.record(proposed, accepted, tick)
        assert (ours.k, ours._miss, ours._resume_tick, ours._pause) == \
            (ref.k, ref._miss, ref._resume_tick, ref._pause)
    assert (ours.proposed, ours.accepted, ours.rollbacks) == \
        (ref.proposed, ref.accepted, ref.rollbacks)
    assert ours.acceptance == ref.acceptance
    after = [c.value() for c in counters]
    assert [a - b for a, b in zip(after, before)] == \
        [ours.proposed, ours.accepted, ours.rollbacks]


# ---------------------------------------------------------------- allocator
def _state(a):
    return (a._free, a._tables, a._lens, a._ref, a._digest, a._index,
            list(a._evictable), a._extra, a._tokens, a._base, a.last_fork)


def _same(ours, ref):
    ours.check_invariants()
    ref.check_invariants()
    assert _state(ours) == _state(ref)


def _both(ops, ours, ref):
    for name, *args in ops:
        outs = []
        for a in (ours, ref):
            try:
                outs.append(("ok", getattr(a, name)(*args)))
            except (ValueError, KeyError, MemoryError) as e:
                outs.append((type(e).__name__,))
        assert outs[0] == outs[1], (name, args, outs)
        _same(ours, ref)


ALLOCATOR_OPS = {
    # rollback inside a block, then across a boundary (the appended block
    # comes back)
    "inside_and_across": [("allocate", "s", 2), ("append_token", "s"),
                          ("append_token", "s"), ("rollback", "s", 1),
                          ("append_token", "s"), ("append_token", "s"),
                          ("append_token", "s"), ("rollback", "s", 3),
                          ("rollback", "s", 0), ("free", "s")],
    # the reservation floor: rollback never trims a reserve()d table
    "floor": [("reserve", "s", 2, 16), ("append_token", "s"),
              ("rollback", "s", 2), ("append_token", "s"),
              ("append_token", "s"), ("rollback", "s", 3),
              ("allocate", "t", 4), ("append_token", "t"),
              ("rollback", "t", 1), ("free", "s"), ("free", "t")],
    # a full-prompt hit forks the last shared block; appends land in the
    # fork, a shared block is forked on write, rollbacks trim only private
    "cow": [("allocate", "s0", 8), ("register_prefix", "s0", list(range(8))),
            ("reserve_prefix", "s1", list(range(8)), 12),
            ("append_token", "s1"), ("append_token", "s1"),
            ("append_token", "s1"), ("rollback", "s1", 3),
            ("reserve_prefix", "s2", list(range(4)) + [9, 9], 6),
            ("rollback", "s2", 2), ("append_token", "s2"),
            ("append_token", "s2"), ("free", "s1"), ("free", "s0"),
            ("free", "s2")],
    # validation: negative, too long, duplicate ids, an exhausted pool
    "errors": [("allocate", "s", 2), ("rollback", "s", -1),
               ("rollback", "s", 3), ("allocate", "s", 1),
               ("reserve", "s", 1, 2), ("allocate", "big", 100),
               ("allocate", "t", 12), ("append_token", "s"),
               ("append_token", "s"), ("append_token", "s"),
               ("free", "t"), ("free", "s")],
}


@pytest.mark.parametrize("name", list(ALLOCATOR_OPS))
def test_allocator_append_and_rollback_match_the_reference(name):
    ours = BlockAllocator(num_blocks=6 if name == "errors" else 16,
                          block_size=4, prefix_cache=True)
    ref = JaxAllocator(num_blocks=6 if name == "errors" else 16,
                       block_size=4, prefix_cache=True)
    _both(ALLOCATOR_OPS[name], ours, ref)
    assert ours.used_blocks == 0 and not ours._base


def test_allocator_fork_of_a_shared_block():
    """Appending into a block another table shares forks it (the engine
    refuses such a fork; the allocator records it in last_fork)."""
    ours, ref = BlockAllocator(16, 4), JaxAllocator(16, 4)
    ops = [("allocate", "a", 8), ("register_prefix", "a", list(range(8))),
           ("reserve_prefix", "b", list(range(8)) + [1, 2], 12),
           ("rollback", "b", 3)]
    _both(ops, ours, ref)
    _both([("append_token", "b")], ours, ref)        # writes shared block 2
    assert ours.last_fork is not None and ours.last_fork[0] == \
        ours.table("a")[1]
    assert ours.refcount(ours.last_fork[0]) == 1
    _both([("free", "a"), ("free", "b")], ours, ref)


# ------------------------------------------------------------- models
def _np_state(jax_model, seed, std=0.05):
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in jax_model.state_dict().items():
        shape = tuple(v.shape)
        if name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif len(shape) == 1:                    # norm weights
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def _pair(kind, zero=False):
    if kind == "gpt":
        jm, tm = JaxGPT(JaxGPTConfig.tiny()), GPTForCausalLM(
            GPTConfig.tiny(), device="cpu")
    else:
        jm, tm = JaxLlama(JaxLlamaConfig.tiny()), LlamaForCausalLM(
            LlamaConfig.tiny(), device="cpu")
    jm.eval()
    state = _np_state(jm, seed=3, std=0.05)
    if zero:
        state = {k: np.zeros_like(v) for k, v in state.items()}
    jm.set_state_dict(state)
    load_jax_state_dict(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def gpt_pair():
    return _pair("gpt")


@pytest.fixture(scope="module")
def llama_pair():
    return _pair("llama")


@pytest.fixture(scope="module")
def zero_gpt():
    return _pair("gpt", zero=True)[1]


def _jax_logits(out):
    logits, caches = out
    return np.asarray(logits.numpy()), [
        (np.asarray(k.numpy() if isinstance(k, Tensor) else k),
         np.asarray(v.numpy() if isinstance(v, Tensor) else v))
        for k, v in caches]


def _jax_cache(b, max_len):
    return [(jnp.zeros((b, max_len, 4, 32)), jnp.zeros((b, max_len, 4, 32)))
            for _ in range(2)]


def test_gpt_contiguous_cache_logits_match(gpt_pair):
    """Scalar pos: a 10-token prefill and one decode step."""
    jm, tm = gpt_pair
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 1024, (2, 10))
    nxt = rng.integers(0, 1024, (2, 1))
    jc = [(Tensor(k), Tensor(v)) for k, v in _jax_cache(2, 16)]
    tc = init_kv_cache(2, 16, 2, 4, 32, torch.float32, "cpu")
    with torch.no_grad():
        for x, p in ((ids, 0), (nxt, 10)):
            want, jcs = _jax_logits(jm(paddle.to_tensor(x.astype(np.int32)),
                                       caches=jc, pos=p))
            got, tc = tm(torch.from_numpy(x), caches=tc, pos=p)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                       rtol=1e-4)
            jc = [(Tensor(jnp.asarray(k)), Tensor(jnp.asarray(v)))
                  for k, v in jcs]
            for (k, v), (jk, jv) in zip(tc, jcs):
                np.testing.assert_allclose(k.numpy(), jk, atol=1e-5)


def test_gpt_per_row_pos_batched_prefill_logits_match(gpt_pair):
    jm, tm = gpt_pair
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 1024, (3, 6))
    pos = np.array([0, 4, 9], np.int32)
    caches = [(rng.standard_normal((3, 16, 4, 32)).astype(np.float32),
               rng.standard_normal((3, 16, 4, 32)).astype(np.float32))
              for _ in range(2)]
    want, jcs = _jax_logits(jm(
        paddle.to_tensor(ids.astype(np.int32)),
        caches=[(Tensor(jnp.asarray(k)), Tensor(jnp.asarray(v)))
                for k, v in caches], pos=paddle.to_tensor(pos)))
    with torch.no_grad():
        got, tcs = tm(torch.from_numpy(ids),
                      caches=[tuple(_t(k, v)) for k, v in caches],
                      pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    for (k, v), (jk, jv) in zip(tcs, jcs):
        np.testing.assert_allclose(v.numpy(), jv, atol=1e-5)


@pytest.mark.parametrize("s", [1, 3])
def test_gpt_paged_logits_and_pages_match(gpt_pair, s):
    """The paged decode step (s = 1) and a verify window (s = 3)."""
    jm, tm = gpt_pair
    rng = np.random.default_rng(7 + s)
    slots, bs, maxb = 3, 4, 4
    nb = slots * maxb + 1
    pages = [(rng.standard_normal((nb, bs, 4, 32)).astype(np.float32),
              rng.standard_normal((nb, bs, 4, 32)).astype(np.float32))
             for _ in range(2)]
    bt = np.arange(1, nb, dtype=np.int32).reshape(slots, maxb)
    lens = np.array([5, 0, 12], np.int32)
    ids = rng.integers(0, 1024, (slots, s))
    jc = [JaxPagedCache(Tensor(jnp.asarray(k)), Tensor(jnp.asarray(v)),
                        Tensor(jnp.asarray(bt)), Tensor(jnp.asarray(lens)))
          for k, v in pages]
    want, jcs = _jax_logits(jm(paddle.to_tensor(ids.astype(np.int32)),
                               caches=jc))
    tc = [PagedLayerCache(*_t(k, v, bt, lens)) for k, v in pages]
    with torch.no_grad():
        got, tcs = tm(torch.from_numpy(ids), caches=tc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    for (k, v), (jk, jv) in zip(tcs, jcs):
        np.testing.assert_allclose(k.numpy(), jk, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), jv, atol=1e-5)


def test_gpt_positions_past_the_wpe_table_never_nan(gpt_pair):
    """Batched-prefill bucket padding and a window's padded tail past
    max_position_embeddings (256): positions clamp to the table's last row,
    nothing raises, and no NaN reaches the pool."""
    _, tm = gpt_pair
    with torch.no_grad():
        caches = init_kv_cache(2, 264, 2, 4, 32, torch.float32, "cpu")
        logits, caches = tm(torch.zeros(2, 8, dtype=torch.int64),
                            caches=caches,
                            pos=torch.tensor([250, 3], dtype=torch.int32))
        assert bool(torch.isfinite(logits).all())
        assert all(bool(torch.isfinite(k).all()) for k, _ in caches)
        kp = torch.zeros(9, 8, 4, 32)
        bt = torch.arange(1, 9, dtype=torch.int32).reshape(1, 8)
        pc = [PagedLayerCache(kp, kp.clone(), bt,
                              torch.tensor([253], dtype=torch.int32))
              for _ in range(2)]
        logits, _ = tm(torch.ones(1, 5, dtype=torch.int64), caches=pc)
        assert bool(torch.isfinite(logits).all())
        assert all(bool(torch.isfinite(c.k_pages).all()) for c in pc)


def test_gpt_batched_prefill_row_past_the_wpe_table(gpt_pair):
    """A batched-prefill row whose bucket padding runs past GPT's
    max_position_embeddings (a 240-token cached prefix, a 5-token suffix
    padded to the burst's 24): the port clamps the learned positions and
    serves the prompt as generate() does. (The reference's `jnp.take`
    fills NaN past the wpe table, and its engine answers 0s for the row;
    see ROADMAP.md.)"""
    _, tm = gpt_pair
    rng = np.random.default_rng(2)
    pre = [int(t) for t in rng.integers(0, 1024, 240)]
    a = pre + [int(t) for t in rng.integers(0, 1024, 5)]
    b = [int(t) for t in rng.integers(0, 1024, 20)]
    eng = ServingEngine(tm, device="cpu", max_slots=4, block_size=8,
                        prefill_chunk=32)
    eng.generate([pre + [1]], max_new_tokens=2)   # registers the prefix
    out = eng.generate([a, b], max_new_tokens=4)
    assert eng.stats()["batched_prefills"] == 1
    for p, o in zip((a, b), out):
        want = tm.generate(torch.tensor([p]), max_new_tokens=4)[0].tolist()
        assert o == want
    assert all(bool(torch.isfinite(k).all()) for k, _ in eng.pool.layers)


def test_spec_window_past_the_wpe_table_keeps_other_slots_right(gpt_pair):
    """A request 4 tokens short of max_model_len = max_position_embeddings
    (256) runs verify windows whose padded tail (positions 256..) lies past
    the wpe table and past its block table, beside a repetitive request
    that drafts. The port clamps the positions, the tail lands in the null
    page finite, and both requests get their spec-off tokens. (The
    reference's `jnp.take` fills NaN there; the NaN K/V land in the null
    page, which every shorter slot's table names past its reservation, and
    the XLA fallback's 0 * NaN turns the drafting request's last tokens
    into 0: see ROADMAP.md.)"""
    _, tm = gpt_pair
    rng = np.random.default_rng(8)
    near_end = [int(t) for t in rng.integers(0, 1024, 252)]
    drafting = [7, 8] * 10
    kw = dict(max_slots=2, block_size=8, prefill_chunk=16)
    outs = []
    for spec_k in (4, 0):
        eng = ServingEngine(tm, device="cpu", spec_k=spec_k, **kw)
        reqs = [eng.submit(drafting, max_new_tokens=40),
                eng.submit(near_end, max_new_tokens=8)]
        eng.run_until_idle()
        outs.append([r.output_tokens for r in reqs])
        assert all(bool(torch.isfinite(k).all()) for k, _ in eng.pool.layers)
        assert eng.stats()["kv"]["used_blocks"] == 0
        assert (eng.spec_ticks > 0) == (spec_k > 0)
    assert outs[0] == outs[1]
    # the engine emits one token past the context (it is never cached);
    # generate() stops at max_position_embeddings
    assert len(outs[0][1]) == 5
    for p, o in zip((drafting, near_end), outs[0]):
        want = tm.generate(torch.tensor([p]), max_new_tokens=40)[0].tolist()
        assert (p + o)[:len(want)] == want


# ---------------------------------------------------------------- engine
def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [[7, 8] * 10,                                       # repetitive
            [int(x) for x in rng.integers(0, vocab, 13)],      # random
            [5] * 8,                                           # constant
            [3, 1, 4, 1, 5, 9, 2, 6] * 3 + [3, 1, 4]]          # copy


@pytest.mark.parametrize("kind", ["llama", "gpt"])
@pytest.mark.parametrize("cache", [True, False], ids=["cache", "nocache"])
def test_spec_engine_matches_jax_engine_off_and_generate(
        kind, cache, llama_pair, gpt_pair):
    jm, tm = llama_pair if kind == "llama" else gpt_pair
    prompts = _prompts(tm.config.vocab_size)
    kw = dict(max_slots=3, block_size=8, prefill_chunk=8,
              prefix_cache=cache)
    on = ServingEngine(tm, device="cpu", spec_k=4, **kw)
    got = on.generate(prompts, max_new_tokens=12)
    jon = JaxEngine(jm, spec_k=4, **kw)
    assert got == jon.generate(prompts, max_new_tokens=12)
    off = ServingEngine(tm, device="cpu", spec_k=0, **kw)
    assert got == off.generate(prompts, max_new_tokens=12)
    for p, g in zip(prompts, got):
        want = tm.generate(torch.tensor([p]), max_new_tokens=12)[0].tolist()
        assert g == want
    st, jst = on.stats(), jon.stats()
    assert st["speculative"] == jst["speculative"]
    assert st["steps"] == jst["steps"] and st["steps"] < off.stats()["steps"]
    s = st["speculative"]
    assert s["ticks"] > 0 and s["accepted"] > 0 and s["rollbacks"] > 0
    assert off.stats()["speculative"]["ticks"] == 0
    assert st["kv"]["used_blocks"] == 0 and st["reserved_blocks"] == 0
    on.allocator.check_invariants()


def test_allocator_length_matches_the_reference_through_mixed_ticks(
        llama_pair):
    """Only spec ticks advance the allocator's length (the plain tick
    never appends), in both engines: after every tick each request's
    allocator length is the reference's."""
    jm, tm = llama_pair
    kw = dict(max_slots=3, block_size=8, prefill_chunk=8, spec_k=3,
              spec_pause=2)
    ours = ServingEngine(tm, device="cpu", **kw)
    ref = JaxEngine(jm, **kw)
    prompts = _prompts(512)[:3]
    for i, p in enumerate(prompts):
        ours.submit(p, max_new_tokens=20, request_id=f"r{i}")
        ref.submit(p, max_new_tokens=20, request_id=f"r{i}")
    plain = spec = 0
    while ours.sched.has_work():
        before = ours.spec_ticks
        ours.step()
        ref.step()
        if ours.sched.running:
            spec += ours.spec_ticks > before
            plain += ours.spec_ticks == before
        assert ours.allocator._lens == ref.allocator._lens
        assert ours.spec_ticks == ref.spec_ticks
    assert not ref.sched.has_work()
    assert spec > 0 and plain > 0


def test_zero_model_speculates_with_fewer_steps(zero_gpt):
    kw = dict(max_slots=2, block_size=8, prefill_chunk=8)
    prompt = [5, 0, 0, 0, 0]
    on = ServingEngine(zero_gpt, device="cpu", spec_k=4, **kw)
    off = ServingEngine(zero_gpt, device="cpu", spec_k=0, **kw)
    out = on.generate([prompt], max_new_tokens=24)
    assert out == off.generate([prompt], max_new_tokens=24)
    assert out[0] == prompt + [0] * 24
    s = on.stats()["speculative"]
    assert s["accepted"] > 0 and s["ticks"] > 0
    assert s["acceptance"] == 1.0 and s["rollbacks"] == 0
    assert on.steps < off.steps


def test_zero_model_rejection_rolls_back_exactly(zero_gpt):
    """After the first 0 the history's suffix (3, 0) last continued with 9:
    the first draft is wrong, rejected in full and rolled back; later
    ticks recover on the constant stream."""
    kw = dict(max_slots=2, block_size=8, prefill_chunk=8)
    on = ServingEngine(zero_gpt, device="cpu", spec_k=4, spec_pause=4, **kw)
    off = ServingEngine(zero_gpt, device="cpu", spec_k=0, **kw)
    prompt = [3, 0, 9, 5, 3]
    assert on.generate([prompt], max_new_tokens=16) == \
        off.generate([prompt], max_new_tokens=16)
    s = on.stats()["speculative"]
    assert s["proposed"] > 0 and s["rollbacks"] >= 1 and s["accepted"] > 0
    assert on.stats()["kv"]["used_blocks"] == 0


class _Successor(torch.nn.Module):
    """A scripted causal LM for the engine: the greedy next token is the
    input token + 1 (mod 64), so a counting prompt's continuation, and the
    drafts that copy it, are known in advance. It leaves the caches as
    they are."""

    vocab = 64

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    @property
    def device(self):
        return self.anchor.device

    def _decode_geometry(self):
        return 1, 1, 4, 256

    def _cache_dtype(self):
        return torch.float32

    def forward(self, ids, caches=None, pos=None):
        nxt = (ids + 1) % self.vocab
        return torch.nn.functional.one_hot(nxt, self.vocab).float(), caches


def test_eos_inside_an_accepted_window(zero_gpt):
    """The history [3, 4, 5, 6, 7, 8, 9, 2, 3] + [4] drafts 5, 6, 7, 8 (the
    prompt's continuation of (3, 4)); the successor model accepts all four
    and adds 9. With eos 7 the window's accepted 8 and bonus 9 are cut and
    the request stops at 7, as it does without speculation."""
    kw = dict(max_slots=2, block_size=8, prefill_chunk=16)
    prompt = [3, 4, 5, 6, 7, 8, 9, 2, 3]
    outs = []
    for spec_k in (4, 0):
        eng = ServingEngine(_Successor(), device="cpu", spec_k=spec_k, **kw)
        req = eng.submit(prompt, max_new_tokens=24, eos_token_id=7)
        eng.run_until_idle()
        outs.append(req.output_tokens)
        assert req.finish_reason == "stop"
        assert eng.stats()["kv"]["used_blocks"] == 0
    assert outs[0] == outs[1] == [4, 5, 6, 7]
    # the window itself: without eos, the tick that prefills the prompt
    # (first token 4) verifies 5, 6, 7, 8 and adds 9
    eng = ServingEngine(_Successor(), device="cpu", spec_k=4, **kw)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.step()
    assert req.output_tokens == [4, 5, 6, 7, 8, 9]
    assert req.finish_reason == "length"
    s = eng.stats()["speculative"]
    assert (s["ticks"], s["proposed"], s["accepted"]) == (1, 4, 4)
    # a zero-weight model whose first token is eos stops there
    eng = ServingEngine(zero_gpt, device="cpu", spec_k=4, max_slots=2,
                        block_size=8, prefill_chunk=8)
    req = eng.submit([5, 0, 0, 0, 0], max_new_tokens=24, eos_token_id=0)
    eng.run_until_idle()
    assert req.output_tokens == [0] and req.finish_reason == "stop"


@pytest.mark.parametrize("budget", [7, 1, 2])
def test_max_new_tokens_kept_through_windows(zero_gpt, budget):
    eng = ServingEngine(zero_gpt, device="cpu", spec_k=4, max_slots=2,
                        block_size=8, prefill_chunk=8)
    out = eng.generate([[5, 0, 0, 0, 0]], max_new_tokens=budget)
    assert len(out[0]) == 5 + budget


def test_sampled_rider_takes_one_token_a_tick(zero_gpt):
    """A temperature > 0 request rides the spec tick with no draft: it
    takes exactly one token a tick, while the greedy request keeps its
    spec-off answer."""
    kw = dict(max_slots=2, block_size=8, prefill_chunk=8)
    eng = ServingEngine(zero_gpt, device="cpu", spec_k=4, seed=1, **kw)
    greedy = eng.submit([5, 0, 0, 0, 0], max_new_tokens=16)
    rider = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6, temperature=0.8)
    spec_ticks_with_rider = 0

    def taken():
        # tokens emitted, fetched or still deferred on the device
        return len(rider.output_tokens) + rider._pending_n

    while eng.sched.has_work():
        n_rider, ticks = taken(), eng.spec_ticks
        running = rider.state == "running"
        eng.step()
        if running:
            assert taken() == n_rider + 1
            spec_ticks_with_rider += eng.spec_ticks > ticks
    assert spec_ticks_with_rider > 0 and len(rider.output_tokens) == 6
    assert all(0 <= t < 1024 for t in rider.output_tokens)
    off = ServingEngine(zero_gpt, device="cpu", spec_k=0, **kw)
    assert greedy.prompt + greedy.output_tokens == off.generate(
        [[5, 0, 0, 0, 0]], max_new_tokens=16)[0]
    assert eng.stats()["speculative"]["accepted"] > 0
    assert eng.stats()["kv"]["used_blocks"] == 0     # a clean drain
    eng.allocator.check_invariants()


def test_stats_telemetry_and_flags(zero_gpt):
    from paddle_tpu_torch.core import flags

    eng = ServingEngine(zero_gpt, device="cpu", spec_k=4, max_slots=2,
                        block_size=8, prefill_chunk=8)
    req = eng.submit([5, 0, 0, 0, 0], max_new_tokens=12)
    eng.run_until_idle()
    s = eng.stats()["speculative"]
    assert s["enabled"] and s["k"] == 4
    assert set(s) == {"enabled", "k", "ticks", "proposed", "accepted",
                      "rollbacks", "acceptance"}
    assert (eng.spec_ticks, eng.spec_proposed, eng.spec_accepted,
            eng.spec_rollbacks) == (s["ticks"], s["proposed"],
                                    s["accepted"], s["rollbacks"])
    t = req.telemetry()
    assert t["spec_proposed"] >= t["spec_accepted"] > 0
    assert 0.0 <= t["spec_acceptance"] <= 1.0
    assert {"serving_spec_proposed_total", "serving_spec_accepted_total",
            "serving_spec_rollbacks_total"} <= set(REGISTRY._metrics)
    assert (flags.get_flag("serving_spec_k"),
            flags.get_flag("serving_spec_ngram"),
            flags.get_flag("serving_spec_pause")) == (0, 3, 32)
    flags.set_flags({"serving_spec_k": 2, "serving_spec_ngram": 4,
                     "serving_spec_pause": 5})
    try:
        e2 = ServingEngine(zero_gpt, device="cpu", max_slots=2,
                           block_size=8, prefill_chunk=8)
        assert (e2.spec_k, e2.spec_ngram, e2.spec_pause) == (2, 4, 5)
    finally:
        flags.set_flags({"serving_spec_k": 0, "serving_spec_ngram": 3,
                         "serving_spec_pause": 32})
    assert not ServingEngine(zero_gpt, device="cpu", max_slots=2,
                             block_size=8, prefill_chunk=8).stats()[
        "speculative"]["enabled"]
