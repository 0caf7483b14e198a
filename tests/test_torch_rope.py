"""The port's RoPE of q and k (one kernel launch for both) against the JAX
reference, on the CPU.

paddle_tpu_torch.ops.gpu.rope rotates q and k in one call: `rope_qk` (its
plain version `rope_qk_plain` on CPU tensors, the CUDA kernel of
csrc/rope.cu on the card), and `RopeQKFunction`, whose backward is the same
call with sign -1 on (gq, gk). These tests hold them against the Pallas
kernels of paddle_tpu/ops/pallas/rope.py run in interpret mode
(`fused_rope` and `fused_rope_packed` with interpret=True, and `jax.vjp`
of them), on the same numpy inputs. chip_smoke.py holds the kernel against
the same plain version on the card.

Tolerances: both sides compute x * cos and rot(x) * sin in fp32 and add
them, so fp32 agrees to 1e-5 (absolute and relative: XLA may fuse the
product and the add, one rounding apart); bf16 and fp16 round that fp32
value once, so they may differ by one rounding of the output, 2**-7 and
2**-10 relative (of at least 1e-2, where a value near 0 rounds on an
absolute grid).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.ops.gpu import _build, rope

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7),
          "f16": (jnp.float16, torch.float16, 2.0 ** -10)}


def _pair(a, jdt, tdt):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


def _close(got, want, tdt, rel):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(got).all()
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=rel, rtol=rel)
    else:
        tol = rel * np.maximum(np.abs(want), 1e-2)
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _tables(rng, P, d):
    """General fp32 tables whose two halves differ (Llama's are equal):
    a rotation at seeded frequencies per column, not per half."""
    ang = np.outer(np.arange(P), rng.uniform(0.01, 1.0, d))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _inputs(seed, b=2, s=8, hq=4, hkv=2, d=16, P=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    gq = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    gk = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    cos, sin = _tables(rng, P, d)
    # row 0 runs past the table's last row (P - 1): clamped to it
    pos = np.stack([np.arange(P - 3, P - 3 + s),
                    rng.integers(0, P, s)]).astype(np.int32)
    return q, k, gq, gk, cos, sin, pos


def _reference(jq, jk, cos, sin, pos, start, s):
    """The JAX package's call: contiguous windows [start, start + s) of the
    tables where pos is None, else per-token positions."""
    if pos is None:
        win = (jnp.asarray(cos[start:start + s]),
               jnp.asarray(sin[start:start + s]))
        return lambda a, b_: jrope.fused_rope(a, b_, *win, interpret=True)
    tabs = (jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(pos))
    return lambda a, b_: jrope.fused_rope_packed(a, b_, *tabs,
                                                 interpret=True)


def _port_args(cos, sin, pos, start, s):
    if pos is None:
        return (torch.from_numpy(cos[start:start + s].copy()),
                torch.from_numpy(sin[start:start + s].copy()), None)
    return torch.from_numpy(cos), torch.from_numpy(sin), torch.from_numpy(pos)


@pytest.mark.parametrize("per_token", [False, True],
                         ids=["contiguous", "per_token"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_rope_qk_plain_matches_pallas(dt, per_token):
    """q (4 heads) and k (2 heads, GQA) in one call against the two Pallas
    calls: a contiguous window that starts at row 5, or per-token positions
    with a row past the table."""
    jdt, tdt, rel = DTYPES[dt]
    q, k, _, _, cos, sin, pos = _inputs(1)
    s = q.shape[1]
    pos = pos if per_token else None
    (jq, tq), (jk, tk) = _pair(q, jdt, tdt), _pair(k, jdt, tdt)
    want = _reference(jq, jk, cos, sin, pos, 5, s)(jq, jk)
    tc, ts, tp = _port_args(cos, sin, pos, 5, s)
    got = rope.rope_qk(tq, tk, tc, ts, tp)
    for a, b_ in zip(got, rope.rope_qk_plain(tq, tk, tc, ts, tp)):
        assert torch.equal(a, b_)
    for g, w, x in zip(got, want, (tq, tk)):
        assert g.dtype == tdt and g.shape == x.shape
        _close(g, w, tdt, rel)
    # the one-tensor entries and the model's op give the same values
    one = (rope.rope(tq, tc, ts) if tp is None
           else rope.rope_packed(tq, tc, ts, tp))
    assert torch.equal(one, got[0])
    op = (tops.rotary_position_embedding(tq, tk, tc, ts) if tp is None
          else tops.rotary_position_embedding_packed(tq, tk, tc, ts,
                                                     tp.long()))
    for a, b_ in zip(op, got):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("per_token", [False, True],
                         ids=["contiguous", "per_token"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_rope_qk_sign_minus_one_is_the_pallas_vjp(dt, per_token):
    """sign -1 on (gq, gk) in one call is the reference's gradient of q and
    k: jax.vjp of the Pallas calls in interpret mode."""
    jdt, tdt, rel = DTYPES[dt]
    q, k, gq, gk, cos, sin, pos = _inputs(2)
    s = q.shape[1]
    pos = pos if per_token else None
    (jq, _), (jk, _) = _pair(q, jdt, tdt), _pair(k, jdt, tdt)
    (jgq, tgq), (jgk, tgk) = _pair(gq, jdt, tdt), _pair(gk, jdt, tdt)
    _, vjp = jax.vjp(_reference(jq, jk, cos, sin, pos, 3, s), jq, jk)
    want = vjp((jgq, jgk))
    got = rope.rope_qk(tgq, tgk, *_port_args(cos, sin, pos, 3, s), sign=-1)
    for g, w in zip(got, want):
        _close(g, w, tdt, rel)


@pytest.mark.parametrize("wants", ["both", "q_only", "k_only", "q_is_k"])
@pytest.mark.parametrize("per_token", [False, True],
                         ids=["contiguous", "per_token"])
def test_joint_function_gradients(per_token, wants):
    """RopeQKFunction's gradients against jax.vjp when q and k both want
    one, when only q or only k does (the other gets none), and when q is k
    (fused_rope(x, x, ...): the two gradients add up)."""
    q, k, gq, gk, cos, sin, pos = _inputs(3, hkv=4)
    s = q.shape[1]
    pos = pos if per_token else None
    jq, jk = jnp.asarray(q), jnp.asarray(k if wants != "q_is_k" else q)
    _, vjp = jax.vjp(_reference(jq, jk, cos, sin, pos, 2, s), jq, jk)
    wq, wk = vjp((jnp.asarray(gq), jnp.asarray(gk)))
    tq = torch.from_numpy(q.copy()).requires_grad_(wants != "k_only")
    tk = (tq if wants == "q_is_k" else
          torch.from_numpy(k.copy()).requires_grad_(wants != "q_only"))
    tc, ts, tp = _port_args(cos, sin, pos, 2, s)
    fn = rope.fused_rope if tp is None else rope.fused_rope_packed
    outs = fn(tq, tk, tc, ts) if tp is None else fn(tq, tk, tc, ts, tp)
    assert all(o.grad_fn is not None for o in outs)
    torch.autograd.backward(outs, (torch.from_numpy(gq),
                                   torch.from_numpy(gk)))
    if wants == "q_is_k":
        _close(tq.grad, wq + wk, torch.float32, 1e-5)
        return
    for x, w, wanted in ((tq, wq, wants != "k_only"),
                         (tk, wk, wants != "q_only")):
        if wanted:
            _close(x.grad, w, torch.float32, 1e-5)
        else:
            assert x.grad is None


def test_joint_function_takes_a_missing_output_gradient():
    """Only q's output reaches the loss: k's output gradient arrives as
    None (not materialised) and k's input gradient is None."""
    q, k, _, _, cos, sin, pos = _inputs(4)
    tq = torch.from_numpy(q).requires_grad_(True)
    tk = torch.from_numpy(k).requires_grad_(True)
    oq, _ = rope.fused_rope_packed(tq, tk, *map(torch.from_numpy,
                                                (cos, sin, pos)))
    oq.sum().backward()
    want = rope.rope_packed_plain(torch.ones_like(tq), torch.from_numpy(cos),
                                  torch.from_numpy(sin),
                                  torch.from_numpy(pos), sign=-1)
    assert torch.equal(tq.grad, want)
    assert tk.grad is None


def test_rope_qk_with_one_tensor_and_none():
    """Either side of the call may be None and stays None."""
    q, k, _, _, cos, sin, pos = _inputs(5)
    args = tuple(map(torch.from_numpy, (cos, sin, pos)))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    oq, none = rope.rope_qk(tq, None, *args)
    assert none is None and torch.equal(oq, rope.rope_qk(tq, tk, *args)[0])
    none, ok = rope.rope_qk(None, tk, *args)
    assert none is None and torch.equal(ok, rope.rope_qk(tq, tk, *args)[1])
    assert rope.rope_qk(None, None, *args) == (None, None)


def test_kernel_checks_refuse_what_the_kernel_does_not_take():
    """The checks the CUDA path runs once per fused call: k's batch, length,
    width or dtype unlike q's, tables other than fp32 [rows, d], a
    contiguous table of another length, positions other than int32 [b, s],
    a non-contiguous tensor, an odd d; and devices without a kernel."""
    q = torch.zeros(2, 8, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    cos = sin = torch.zeros(8, 16)
    tab = torch.zeros(24, 16)
    pos = torch.zeros(2, 8, dtype=torch.int32)
    rope._check(q, k, cos, sin, None)
    rope._check(q, k, tab, tab, pos)
    rope._check(None, k, tab, tab, pos)
    bad = [(q, k[:, :4], cos, sin, None),
           (q, torch.zeros(2, 8, 2, 8), cos, sin, None),
           (q, k.half(), cos, sin, None),
           (q, k, cos.double(), sin.double(), None),
           (q, k, torch.zeros(8, 8), torch.zeros(8, 8), None),
           (q, k, tab, tab, None),
           (q, k, tab, tab, pos.long()),
           (q, k, tab, tab, pos[:, :4]),
           (q.transpose(1, 2), k, cos, sin, None),
           (torch.zeros(2, 8, 4, 15), None, torch.zeros(8, 15),
            torch.zeros(8, 15), None),
           (None, None, cos, sin, None)]
    for args in bad:
        with pytest.raises(ValueError):
            rope._check(*args)
    with pytest.raises(TypeError):
        rope._check(q.double(), k.double(), cos, sin, None)
    with pytest.raises(ValueError):
        rope.rope_qk(q.to("meta"), k.to("meta"), cos.to("meta"),
                     sin.to("meta"))


def test_cpu_calls_launch_nothing_and_op_converts_only_what_differs():
    """On CPU tensors no call counts a launch; the model's op passes fp32
    tables and int32 positions to the kernel module as they are and
    converts others (a bf16 table, int64 positions)."""
    q, k, _, _, cos, sin, pos = _inputs(6)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tc, ts, tp = map(torch.from_numpy, (cos, sin, pos))
    before = (rope.rope.launches, rope.rope_packed.launches)
    want = rope.rope_qk(tq, tk, tc, ts, tp)
    assert (rope.rope.launches, rope.rope_packed.launches) == before
    assert tops._kernel_form(tc, torch.float32) is tc
    assert tops._kernel_form(tp, torch.int32) is tp
    assert tops._kernel_form(tp.long(), torch.int32).dtype == torch.int32
    wide = torch.zeros(24, 32)
    wide[:, ::2] = tc
    view = tops._kernel_form(wide[:, ::2], torch.float32)
    assert view.is_contiguous() and torch.equal(view, tc)
    got = tops.rotary_position_embedding_packed(tq, tk, tc, ts, tp.long())
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_build_holds_the_rope_source():
    """csrc/rope.cu is one of the sources _build compiles (one nvcc per
    source) into paddle_tpu_torch/build/, and the module holds no Triton
    kernel."""
    srcs = _build.sources()
    assert "rope" in srcs and srcs["rope"].name == "rope.cu"
    assert set(srcs) >= {"fused_norm", "paged_attention", "flash_attention",
                         "rope"}
    assert _build._lib_path("rope").parent == _build.BUILD_DIR
    assert "triton" not in open(rope.__file__).read()
