"""amp O2 in the port against the JAX reference, on the CPU.

`auto_cast(level="O2")` and `decorate`; the fused AdamW kernel's master
form (its plain version: the fp32 master, bf16 gradients, the bf16 copy and
the skip flag) against the Pallas kernel in interpret mode and the
reference's `functional_update` through the master; AdamW with
`multi_precision` and its `state_dict`; `GradScaler` and
`LossScaleBackoff`; and three amp O2 TrainSteps of a tiny GPT against the
reference's compiled O2 TrainStep. Inputs come from numpy seeds and go
through both packages; each comparison states its tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.amp import LossScaleBackoff as JaxBackoff
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.nn.layer import Parameter as JaxParameter
from paddle_tpu.ops.pallas.fused_adamw import fused_adamw_update
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Embedding
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.ops.gpu import fused_adamw
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
STEPS = 3
SEQ = 128
B1, B2 = np.float32(0.9), np.float32(0.999)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if hasattr(x, "_value"):
        x = x._value
    return np.array(jnp.asarray(x, jnp.float32))


def _dt(x):
    """A tensor's dtype in torch's names, from either package."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}[jnp.dtype(
                x._value.dtype)]


# ------------------------------------------------------------ the cast rule
@pytest.mark.parametrize("decorated", [False, True],
                         ids=["fp32_params", "decorated"])
def test_o2_casts_each_op_category_as_the_reference(decorated):
    """Output dtypes under auto_cast(level="O2", bf16) in both packages, op
    by op: white (linear, matmul, attention), black (LayerNorm, cross
    entropy) and ops with no category (GELU, the residual add, dropout, the
    embedding lookup), on fp32 inputs and weights (O2 without decorate)
    and on the bf16 ones `decorate` gives a model."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 8))
    table = rng.standard_normal((50, 32)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if decorated
                else (jnp.float32, torch.float32))
    jx, tx = paddle.to_tensor(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jw, tw = paddle.to_tensor(w).astype(jdt), torch.from_numpy(w).to(tdt)
    F = paddle.nn.functional
    emb = Embedding(50, 32, device="cpu", dtype=tdt)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(table))
    jemb = paddle.nn.Embedding(50, 32)
    jemb.weight._value = jnp.asarray(table).astype(jdt)
    pairs = {
        "linear": (lambda: F.linear(jx, jw), lambda: tops.linear(tx, tw)),
        "matmul": (lambda: paddle.matmul(jx, jx, transpose_y=True),
                   lambda: tops.matmul(tx, tx, transpose_y=True)),
        "attention": (
            lambda: F.scaled_dot_product_attention(jx, jx, jx,
                                                   is_causal=True),
            lambda: tops.scaled_dot_product_attention(tx, tx, tx,
                                                      is_causal=True)),
        "layer_norm": (lambda: F.layer_norm(jx, 32),
                       lambda: tops.layer_norm(tx, 32)),
        "cross_entropy": (
            lambda: F.cross_entropy(jx.reshape([-1, 32]), paddle.to_tensor(
                np.zeros(512, np.int64))),
            lambda: tops.cross_entropy(tx.reshape(-1, 32),
                                       torch.zeros(512, dtype=torch.long))),
        "gelu": (lambda: F.gelu(jx, approximate=True),
                 lambda: tops.gelu(tx, approximate=True)),
        "add": (lambda: jx + jx, lambda: tx + tx),
        "add_fp32": (lambda: jx + paddle.to_tensor(x),
                     lambda: tx + torch.from_numpy(x)),
        "dropout": (lambda: F.dropout(jx, 0.5, training=True),
                    lambda: tops.dropout(tx, 0.5, training=True)),
        "embedding": (lambda: jemb(paddle.to_tensor(ids)),
                      lambda: emb(torch.from_numpy(ids))),
        "ln_then_linear": (lambda: F.linear(F.layer_norm(jx, 32), jw),
                           lambda: tops.linear(tops.layer_norm(tx, 32), tw)),
    }
    for name, (jf, tf) in pairs.items():
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            want = _dt(jf())
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            got = tf().dtype
            assert amp.amp_state().level == "O2"
        assert got == want, name
    assert amp.amp_state().level == "O1"        # restored
    with pytest.raises(ValueError, match="level"):
        with amp.auto_cast(level="O3"):
            pass


@pytest.fixture(scope="module")
def gpt_state():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _gpt_pair(state, o2=True):
    """The reference and the port with the same weights and AdamW (global
    norm clip at 1.0, weight decay 0.01), decorated for O2."""
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    jopt = JaxAdamW(LR, parameters=jm.parameters(), weight_decay=0.01,
                    grad_clip=JaxClip(1.0))
    topt = AdamW(LR, parameters=tm.parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))
    if o2:
        jm, jopt = paddle.amp.decorate(jm, jopt, level="O2")
        tm, topt = amp.decorate(tm, topt, level="O2")
    return jm, tm, jopt, topt


def _ids(seed=1):
    return np.random.default_rng(seed).integers(
        0, GPTConfig.tiny().vocab_size, (2, SEQ)).astype(np.int32)


def test_gpt_forward_under_o2_matches_the_reference(gpt_state):
    """A decorated tiny GPT's forward under O2, and the fp32 one's: the
    same logits dtype as the reference's, the loss in fp32, and the loss
    within 1e-3 relative (a quarter of one bf16 rounding: the matmuls and
    the residual stream round to bf16 in both, GELU op by op in bf16 in
    the reference and once in torch)."""
    for o2 in (False, True):
        jm, tm, _, _ = _gpt_pair(gpt_state, o2=o2)
        ids = _ids()
        tid = torch.from_numpy(ids.astype(np.int64))
        with paddle.amp.auto_cast(level="O2"):
            jlogits = jm(paddle.to_tensor(ids))
            jloss = float(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(ids)).numpy())
        with amp.auto_cast(level="O2"), torch.no_grad():
            tlogits = tm(tid)
            tloss = tm(tid, labels=tid)
        assert tlogits.dtype == _dt(jlogits) == torch.bfloat16
        assert tloss.dtype == torch.float32
        assert float(tloss) == pytest.approx(jloss, rel=1e-3)


def test_decorate_gives_bf16_parameters_and_masters_from_them(gpt_state):
    """decorate casts in place (the optimizer keeps the same parameter
    objects) and turns on multi_precision; each master starts at
    fp32(bf16(p0)), bitwise the reference's `_get_state` master; with
    master_weight=False the optimizer keeps none."""
    jm, tm, jopt, topt = _gpt_pair(gpt_state)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert topt._parameter_list[0] is tm.gpt.wte.weight
    assert topt._multi_precision and jopt._multi_precision
    topt._materialize_state()
    for jp, tp, (name, v) in zip(jm.parameters(), tm.parameters(),
                                 tm.named_parameters()):
        master = topt._get_state(tp)["master"]
        assert master.dtype == torch.float32
        want = torch.tensor(gpt_state[name]).to(torch.bfloat16).float()
        assert torch.equal(master, want), name
        np.testing.assert_array_equal(master.numpy(),
                                      _np(jopt._get_state(jp)["master"]))
    m2 = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    o2 = AdamW(LR, parameters=m2.parameters())
    amp.decorate(m2, o2, level="O2", master_weight=False)
    assert not o2._multi_precision
    with pytest.raises(NotImplementedError, match="multi_precision"):
        o2._materialize_state()
    # decorating after the flat buffers exist would leave them stale
    with pytest.raises(ValueError, match="first step"):
        amp.decorate(tm, topt, level="O2")


# ------------------------------------------------------- the master form
def _master_case(seed=0):
    """Three parameters' worth of flat state (a ragged total) and three
    steps of bf16 gradients."""
    rng = np.random.default_rng(seed)
    shapes = [(37, 5), (11,), (6, 9)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 3).astype(np.float32)
              for s in shapes] for _ in range(STEPS)]
    return shapes, init, grads


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))


@pytest.mark.parametrize("wd_on", [0, 1])
@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
def test_master_form_matches_pallas_and_functional_update(clip, wd_on):
    """Three steps of the master form's plain version over one flat buffer
    against (a) the Pallas kernel in interpret mode on (master, the clipped
    bf16 gradient, m, v) followed by astype(bf16), and (b) the reference's
    AdamW.functional_update through its masters (multi_precision, bf16
    parameters, the gradients clipped by functional_clip). fp32 master, m
    and v: 1e-6 of the value + 1e-6 of the RMS (the same operations, an
    FMA here and there); against (b), whose eager rule rounds 1 - beta2
    from a double where the kernel subtracts in fp32 (4.7e-5 apart), v
    to 5e-5 relative and m, 1 - beta1's 2.2e-7, within the first bound.
    The bf16 copy equals the port's own master cast
    to bf16, bitwise, and the references' copies to one bf16 ulp (2**-8 of
    the value: masters 1e-6 apart can round to neighbouring bf16
    values)."""
    shapes, init, grads = _master_case()
    sizes = [int(np.prod(s)) for s in shapes]
    p0 = np.concatenate([_bf16(a).astype(np.float32).ravel() for a in init])
    n = p0.size
    wd = 0.01
    # the port: one flat group in the master form
    master = torch.from_numpy(p0.copy())
    low = master.to(torch.bfloat16)
    m, v = torch.zeros(n), torch.zeros(n)
    # (a) the Pallas kernel on the master
    am, amm, av = jnp.asarray(p0), jnp.zeros(n), jnp.zeros(n)
    # (b) functional_update over bf16 parameters with masters
    jparams = [JaxParameter(jnp.asarray(a).astype(jnp.bfloat16))
               for a in init]
    jopt = JaxAdamW(LR, parameters=jparams, weight_decay=wd,
                    multi_precision=True,
                    apply_decay_param_fun=lambda _: bool(wd_on))
    fstate = jopt.init_state_tree(jparams)
    fparams = [jp._value for jp in jparams]
    b1p = b2p = np.float32(1)
    for gs in grads:
        g_bf = [jnp.asarray(g).astype(jnp.bfloat16) for g in gs]
        if clip:
            # the reference's factor, as functional_clip computes it, as
            # the device scalar the port's kernel takes
            clipped = JaxClip(1.0).functional_clip(g_bf)
            sq = sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                     for g in g_bf)
            scale = torch.tensor(_np(1.0 / jnp.maximum(jnp.sqrt(sq), 1.0)))
        else:
            clipped, scale = g_bf, 1.0
        b1p, b2p = np.float32(b1p * B1), np.float32(b2p * B2)
        kw = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=wd * wd_on, bias_correction1=1 - b1p,
                  bias_correction2=1 - b2p)
        gflat = torch.cat([torch.from_numpy(_np(g)).reshape(-1)
                           for g in g_bf]).to(torch.bfloat16)
        got = fused_adamw.fused_adamw_master(master, gflat, m, v, low,
                                             grad_scale=scale, **kw)
        assert got[0] is master and got[1] is m and got[2] is v
        cflat = jnp.concatenate([c.reshape(-1) for c in clipped])
        am, amm, av = fused_adamw_update(am, cflat, amm, av, chunk=64,
                                         interpret=True, **kw)
        fparams, fstate = jopt.functional_update(fparams, clipped, fstate,
                                                 LR)
    assert torch.equal(low, master.to(torch.bfloat16))

    def close(got, want, rel=1e-6):
        got, want = _np(got), _np(want)
        rms = np.sqrt(np.mean(want ** 2))
        assert (np.abs(got - want) <= rel * np.abs(want) + 1e-6 * rms).all()

    def one_ulp(got, want):
        got, want = _np(got), _np(want)
        assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want)).all()

    for got, want in ((master, am), (m, amm), (v, av)):
        close(got, want)
    one_ulp(low, jnp.asarray(am).astype(jnp.bfloat16))
    off = 0
    for k, s in enumerate(sizes):
        sl = slice(off, off + s)
        close(master[sl], fstate[k]["master"].reshape(-1))
        close(m[sl], fstate[k]["moment1"].reshape(-1))
        close(v[sl], fstate[k]["moment2"].reshape(-1), rel=5e-5)
        assert jnp.asarray(fparams[k]).dtype == jnp.bfloat16
        one_ulp(low[sl], fparams[k].reshape(-1))
        off += s


@pytest.mark.parametrize("form", ["fp32", "master"])
def test_skip_flag_stores_nothing(form):
    """A nonzero skip flag (0-d int32) leaves every buffer bitwise as it
    was; a zero flag updates as no flag does."""
    rng = np.random.default_rng(3)
    n = 1000
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    v = torch.from_numpy(rng.random(n).astype(np.float32))
    kw = dict(lr=LR, weight_decay=0.01, bias_correction1=0.1,
              bias_correction2=0.001, grad_scale=torch.tensor(0.5))

    def run(skip):
        bufs = [p.clone(), m.clone(), v.clone()]
        if form == "fp32":
            fused_adamw.fused_adamw(bufs[0], g, bufs[1], bufs[2], skip=skip,
                                    **kw)
            return bufs
        low = torch.zeros(n, dtype=torch.bfloat16)
        fused_adamw.fused_adamw_master(bufs[0], g.to(torch.bfloat16),
                                       bufs[1], bufs[2], low, skip=skip,
                                       **kw)
        return bufs + [low]

    skipped = run(torch.tensor(1, dtype=torch.int32))
    for got, orig in zip(skipped, [p, m, v]):
        assert torch.equal(got, orig)
    if form == "master":
        assert torch.equal(skipped[3], torch.zeros(n, dtype=torch.bfloat16))
    ran = run(torch.tensor(0, dtype=torch.int32))
    for a, b in zip(ran, run(None)):
        assert torch.equal(a, b)
    assert not torch.equal(ran[0], p)


# ------------------------------------------------- AdamW multi_precision
def _mp_pair(fused=True):
    """Four bf16 parameters (weight decay on for 0 and 2) with masters in
    both packages, and three steps of bf16 gradients."""
    shapes, init, grads = _master_case(seed=5)
    shapes.append((4,))
    init.append(np.ones(4, np.float32))
    for gs in grads:
        gs.append(np.full(4, 0.25, np.float32))
    decay = {0, 2}
    jparams = [JaxParameter(jnp.asarray(a).astype(jnp.bfloat16))
               for a in init]
    jnames = {jp.name for i, jp in enumerate(jparams) if i in decay}
    jopt = JaxAdamW(LR, parameters=jparams, weight_decay=0.05,
                    multi_precision=True, grad_clip=JaxClip(1.0),
                    apply_decay_param_fun=lambda nm: nm in jnames)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(
        torch.bfloat16)) for a in init]
    topt = AdamW(LR, parameters=tparams, weight_decay=0.05,
                 multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0),
                 apply_decay_param_fun=lambda nm: int(nm.split("_")[1])
                 in decay)
    return jparams, jopt, tparams, topt, grads


def _step_both(jparams, jopt, tparams, topt, gs):
    for jp, tp, g in zip(jparams, tparams, gs):
        gb = _bf16(g)
        jp.grad = paddle.to_tensor(gb)
        tp.grad = torch.from_numpy(gb.astype(np.float32)).to(torch.bfloat16)
    jopt.step()
    topt.step()
    topt.clear_grad()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_param"])
def test_adamw_multi_precision_matches_the_reference(fused):
    """Three steps of AdamW(multi_precision=True) over bf16 parameters
    (two groups by weight decay, global-norm clip at 1.0) against the
    reference's eager step through its masters; the fused master form and,
    with FLAGS_use_fused_adamw off, the per-parameter rule through the
    master. Masters and moments: 1e-6 absolute + 1e-6 relative (the same
    fp32 operations, the clip's norm summed in another order); parameters:
    their masters cast to bf16 (bitwise in the port, one bf16 ulp from the
    reference's)."""
    jparams, jopt, tparams, topt, grads = _mp_pair()
    tflags.set_flags({"use_fused_adamw": fused})
    try:
        for gs in grads:
            _step_both(jparams, jopt, tparams, topt, gs)
    finally:
        tflags.set_flags({"use_fused_adamw": True})
    assert len(topt._groups) == 2
    assert all(g.master is not None for g in topt._groups)
    for jp, tp in zip(jparams, tparams):
        st, jst = topt._get_state(tp), jopt._get_state(jp)
        assert tp.dtype == torch.bfloat16
        assert torch.equal(tp.detach(), st["master"].to(torch.bfloat16))
        for key in ("master", "moment1", "moment2"):
            np.testing.assert_allclose(_np(st[key]), _np(jst[key]),
                                       atol=1e-6, rtol=1e-6)
        got, want = _np(tp), _np(jp)
        assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want)).all()
        for key in ("beta1_pow", "beta2_pow"):
            assert st[key] == pytest.approx(float(jst[key]), rel=1e-7)


def test_adamw_state_dict_matches_the_reference_and_round_trips():
    """state_dict(): the reference's keys ("{name}.moment1", ...,
    "master_weights", "LR_Scheduler", "step"; names by position in the
    port, by creation order in the reference) and values; set_state_dict()
    into a fresh optimizer over copies of the parameters restores every
    entry in place (the flat buffers' views kept), and one more step from
    it equals one more step of the original bitwise."""
    from paddle_tpu.optimizer.lr import StepDecay as JaxStepDecay
    from paddle_tpu_torch.optimizer.lr import StepDecay

    jparams, jopt, tparams, topt, grads = _mp_pair()
    jopt._learning_rate = JaxStepDecay(LR, 2)
    topt._learning_rate = StepDecay(LR, 2)
    for gs in grads[:2]:
        _step_both(jparams, jopt, tparams, topt, gs)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    rename = {jp.name: f"param_{i}" for i, jp in enumerate(jparams)}

    def port_key(k):
        name, _, slot = k.partition(".")
        return f"{rename[name]}.{slot}" if slot else k

    assert set(tsd) == {port_key(k) for k in jsd}
    assert set(tsd["master_weights"]) == {rename[k]
                                          for k in jsd["master_weights"]}
    assert tsd["step"] == jsd["step"] == 2
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for k, v in jsd.items():
        if k in ("LR_Scheduler", "master_weights", "step"):
            continue
        np.testing.assert_allclose(_np(tsd[port_key(k)]), _np(v),
                                   atol=1e-6, rtol=1e-6)
    for k, v in jsd["master_weights"].items():
        np.testing.assert_allclose(_np(tsd["master_weights"][rename[k]]),
                                   _np(v), atol=1e-6, rtol=1e-6)
    # round trip into a fresh optimizer over copies of the parameters
    copies = [torch.nn.Parameter(p.detach().clone()) for p in tparams]
    fresh = AdamW(LR, parameters=copies, weight_decay=0.05,
                  multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0),
                  apply_decay_param_fun=lambda nm: int(nm.split("_")[1])
                  in {0, 2})
    fresh._learning_rate = StepDecay(LR, 2)
    fresh.set_state_dict({k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in tsd.items()
                          if k != "master_weights"}
                         | {"master_weights": {
                             k: v.clone()
                             for k, v in tsd["master_weights"].items()}})
    assert fresh._step_count == 2
    assert fresh._learning_rate.last_epoch == topt._learning_rate.last_epoch
    for tp, cp in zip(tparams, copies):
        a, b = topt._get_state(tp), fresh._get_state(cp)
        for key in a:
            if torch.is_tensor(a[key]):
                assert torch.equal(a[key], b[key]), key
            else:
                assert a[key] == b[key], key
    (group,) = [g for g in fresh._groups if g.wd_on == 1.0]
    st0 = fresh._get_state(copies[0])
    assert st0["master"].data_ptr() == group.master.data_ptr()
    for p, gs in ((tparams, topt), (copies, fresh)):
        for t, g in zip(p, grads[2]):
            t.grad = torch.from_numpy(_bf16(g).astype(np.float32)).to(
                torch.bfloat16)
        gs.step()
    for tp, cp in zip(tparams, copies):
        assert torch.equal(tp.detach(), cp.detach())


# ------------------------------------------------------ GradScaler
def test_grad_scaler_matches_the_reference():
    """Eight eager steps through GradScaler (init 2**10, incr_every 2,
    decr_every 1) over one fp32 and one bf16 parameter, with infinities
    injected into the gradients at steps 2, 3 and 6: after every step the
    scale, the good and bad counts and found-inf equal the reference's, the
    unscaled gradients equal it bitwise (the same multiply by the inverse
    in the gradient's dtype), a skipped step leaves the parameters alone
    and the optimizer's results agree to 1e-6 (fp32) / one bf16 ulp."""
    rng = np.random.default_rng(7)
    init = [rng.standard_normal((5, 3)).astype(np.float32),
            rng.standard_normal(4).astype(np.float32)]
    dts = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
    jparams = [JaxParameter(jnp.asarray(a).astype(jd))
               for a, (jd, _) in zip(init, dts)]
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(td))
               for a, (_, td) in zip(init, dts)]
    jopt = JaxAdamW(LR, parameters=jparams, multi_precision=True)
    topt = AdamW(LR, parameters=tparams, multi_precision=True)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = JaxGradScaler(**kw), amp.GradScaler(**kw)
    poison = {2, 3, 6}
    for i in range(8):
        scaled = [(rng.standard_normal(a.shape) * 2.0 ** 10).astype(
            np.float32) for a in init]
        if i in poison:
            scaled[i % 2].flat[1] = np.inf
        for jp, tp, g, (jd, td) in zip(jparams, tparams, scaled, dts):
            jp.grad = paddle.to_tensor(jnp.asarray(g).astype(jd))
            tp.grad = torch.from_numpy(_np(jnp.asarray(g).astype(jd))).to(td)
        before = [tp.detach().clone() for tp in tparams]
        js.unscale_(jopt)
        ts.unscale_(topt)
        for jp, tp in zip(jparams, tparams):
            np.testing.assert_array_equal(_np(tp.grad), _np(jp.grad))
        assert ts._found_inf == js._found_inf == (i in poison)
        js.step(jopt)
        ts.step(topt)
        topt.clear_grad()
        assert ts.state_dict() == js.state_dict(), i
        if i in poison:
            for b, tp in zip(before, tparams):
                assert torch.equal(b, tp.detach())
        for jp, tp in zip(jparams, tparams):
            got, want = _np(tp), _np(jp)
            assert (np.abs(got - want)
                    <= 1e-6 + 2.0 ** -8 * np.abs(want)).all()
    assert ts.get_loss_scaling() == js.get_loss_scaling()
    # scale() multiplies in the loss's dtype
    loss = torch.tensor(3.0)
    assert float(ts.scale(loss)) == 3.0 * ts.get_loss_scaling()
    fresh = amp.GradScaler(**kw)
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()



def test_loss_scale_backoff_matches_the_reference():
    """LossScaleBackoff.on_step over a skip pattern drives the scale as the
    reference's does (decr every skip, incr after 3 clean steps), and
    counts the skips; with dynamic scaling off it only counts."""
    pattern = [False, True, True, False, False, False, False, True, False,
               False, False, False, False, False]
    for dynamic in (True, False):
        kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=3,
                  use_dynamic_loss_scaling=dynamic)
        jb = JaxBackoff(JaxGradScaler(**kw))
        tb = amp.LossScaleBackoff(amp.GradScaler(**kw))
        for skipped in pattern:
            jb.on_step(skipped)
            tb.on_step(skipped)
            assert tb.scale == jb.scale
            assert tb.scaler.state_dict() == jb.scaler.state_dict()
        assert tb.skipped_steps == jb.skipped_steps == 3


def test_is_supported_answers_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not amp.is_float16_supported()
    assert not amp.is_bfloat16_supported()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert amp.is_bfloat16_supported() and amp.is_float16_supported("cuda")
    assert not amp.is_bfloat16_supported("cpu")


# ------------------------------------------------------- the O2 slice
def test_o2_train_steps_match_the_reference(gpt_state):
    """Three amp O2 TrainSteps of the decorated tiny GPT (AdamW with
    masters, global-norm clip) against the reference's compiled O2
    TrainStep (flash attention in Pallas interpret mode): losses to 1e-3
    relative, O1's bound (measured ~1e-5: GELU rounds once in torch, op by
    op in the reference). Masters: every element within 2.02 lr a step of
    the reference's (Adam moves an element by |m_hat| / sqrt(v_hat) lr a
    step, at most 1.0036 lr in the first three at beta1 0.9 and beta2
    0.999, so two runs whose bf16 gradients round differently near zero
    can end that far apart), and the mean difference under 0.02 lr.
    Parameters are bf16 and equal their masters cast to bf16 bitwise."""
    jm, tm, jopt, topt = _gpt_pair(gpt_state)
    ids = _ids()

    def jloss(x):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            return jm(x, labels=x)

    def tloss(x):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return tm(x, labels=x)

    paddle.set_flags({"pallas_interpret": True})
    try:
        jstep = JaxTrainStep(jm, jloss, jopt)
        jl = [float(jstep(paddle.to_tensor(ids)).numpy())
              for _ in range(STEPS)]
    finally:
        paddle.set_flags({"pallas_interpret": False})
    tstep = TrainStep(tm, tloss, topt, device="cpu")
    tl = [float(tstep(ids.astype(np.int64))) for _ in range(STEPS)]
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    jstep.sync_to_optimizer()
    diffs = []
    for jp, tp in zip(jm.parameters(), tm.parameters()):
        st = topt._get_state(tp)
        assert tp.dtype == torch.bfloat16
        assert torch.equal(tp.detach(), st["master"].to(torch.bfloat16))
        diffs.append(np.abs(_np(st["master"])
                            - _np(jopt._get_state(jp)["master"])).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2.02 * LR * STEPS
    assert diffs.mean() <= 0.02 * LR
