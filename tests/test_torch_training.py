"""The port's training slice against the JAX reference, on the CPU.

GPT training through paddle_tpu_torch: LayerNorm, GELU, cross entropy and
amp O1 casts; the fused AdamW kernel's plain version and the AdamW
optimizer that launches it once per parameter group; ClipGradByGlobalNorm;
TrainStep; GPTForCausalLM with weights carried over from a JAX model by
load_jax_state_dict. Each is held against its reference on the same numpy
inputs: the Pallas AdamW kernel in interpret mode, the reference's eager
AdamW.step and its per-parameter `_adam_step`, and three steps of the
reference's compiled TrainStep with its flash attention running the Pallas
kernels in interpret mode (FLAGS_pallas_interpret).

Tolerances are stated beside each comparison.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.nn.layer import Parameter as JaxParameter
from paddle_tpu.ops.kernels import nn_ops as jops
from paddle_tpu.ops.pallas.fused_adamw import fused_adamw_update
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_jax_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, LayerNorm
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.ops.gpu import fused_adamw
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 128          # the flash gate's smallest admitted length
STEPS = 3
LR = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ ops and amp
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_norm_gelu_cross_entropy_match_the_reference(dt):
    """fp32: 1e-5 absolute; bf16 (LayerNorm and GELU outputs): one bf16
    rounding of the value, 2**-7 relative, plus 2**-7 of the output's RMS
    for GELU, whose reference evaluates the tanh form op by op in bf16."""
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jw, jb = jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt)
    tw, tb = torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt)

    def close(got, want, rms_term=0.0):
        got, want = _np(got), _np(want)
        if dt == "f32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            rms = np.sqrt(np.mean(want ** 2))
            assert (np.abs(got - want)
                    <= 2 ** -7 * (np.abs(want) + rms_term * rms)).all()

    got = tops.layer_norm(tx, 64, tw, tb, 1e-5)
    assert got.dtype == tdt
    close(got, jops.layer_norm(jx, 64, jw, jb, 1e-5))
    close(tops.gelu(tx, approximate=True),
          jops.gelu(jx, approximate=True), rms_term=1.0)

    logits = rng.standard_normal((12, 50)).astype(np.float32)
    labels = rng.integers(0, 50, 12)
    labels[[2, 7]] = -100
    want = jops.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tops.cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    all_ignored = torch.full((12,), -100)
    assert float(tops.cross_entropy(torch.from_numpy(logits),
                                    all_ignored)) == 0.0


def test_amp_o1_casts_as_the_reference():
    """Output dtypes of the slice's ops under auto_cast(O1, bf16) in both
    packages, on fp32 inputs (white: bf16; black: fp32; others promote)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    jw, tw = paddle.to_tensor(w), torch.from_numpy(w)
    F = paddle.nn.functional
    pairs = [
        (lambda: F.linear(jx, jw), lambda: tops.linear(tx, tw)),
        (lambda: paddle.matmul(jx, jx, transpose_y=True),
         lambda: tops.matmul(tx, tx, transpose_y=True)),
        (lambda: F.scaled_dot_product_attention(jx, jx, jx, is_causal=True),
         lambda: tops.scaled_dot_product_attention(tx, tx, tx,
                                                   is_causal=True)),
        (lambda: F.layer_norm(F.linear(jx, jw), 16),
         lambda: tops.layer_norm(tops.linear(tx, tw), 16)),
        (lambda: F.gelu(F.linear(jx, jw), approximate=True),
         lambda: tops.gelu(tops.linear(tx, tw), approximate=True)),
        (lambda: F.cross_entropy(F.linear(jx, jw).reshape([-1, 16]),
                                 paddle.to_tensor(np.zeros(512, np.int64))),
         lambda: tops.cross_entropy(tops.linear(tx, tw).reshape(-1, 16),
                                    torch.zeros(512, dtype=torch.long))),
        (lambda: jx + F.linear(jx, paddle.to_tensor(np.eye(32, dtype=np.float32))),
         lambda: tx + tops.linear(tx, torch.eye(32))),
    ]
    name = {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for jf, tf in pairs:
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            want = name[jnp.dtype(jf()._value.dtype)]
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            got = tf().dtype
        assert got == want
        assert tf().dtype == torch.float32       # amp off again
    with amp.auto_cast(custom_black_list=["linear"]):
        assert tops.linear(tx, tw).dtype == torch.float32
    # O2 casts the ops O1 casts (its parameters differ: amp.decorate);
    # tests/test_torch_amp_o2.py holds it against the reference
    with amp.auto_cast(level="O2"):
        assert tops.linear(tx, tw).dtype == torch.bfloat16
        assert tops.layer_norm(tx, 32).dtype == torch.float32


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_plain_matches_the_pallas_kernel(wd):
    """A ragged length (5000 over 1024-element chunks: the kernel's pad
    path) and bias corrections from per-parameter beta powers. fp32, both
    sides doing the same operations on the same eight scalars: 1e-6 of the
    value plus 1e-6 of the buffer's RMS (an FMA here and there)."""
    rng = np.random.default_rng(0)
    n = 5000
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = rng.random(n).astype(np.float32) * 0.01
    b1p, b2p = np.float32(0.9) ** 3, np.float32(0.999) ** 3
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd,
              bias_correction1=1 - b1p * np.float32(0.9),
              bias_correction2=1 - b2p * np.float32(0.999), grad_scale=0.5)
    want = fused_adamw_update(*(jnp.asarray(a) for a in (p, g, m, v)),
                              chunk=1024, interpret=True, **kw)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    got = fused_adamw.fused_adamw(tp, torch.from_numpy(g), tm, tv, **kw)
    assert got[0] is tp and got[1] is tm and got[2] is tv   # in place
    for a, b in zip(got, want):
        a, b = _np(a), _np(b)
        rms = np.sqrt(np.mean(b ** 2))
        assert (np.abs(a - b) <= 1e-6 * (np.abs(b) + rms)).all()
    # a device-scalar grad scale gives the same update
    tp2, tm2, tv2 = (torch.from_numpy(a.copy()) for a in (p, m, v))
    fused_adamw.fused_adamw(tp2, torch.from_numpy(g), tm2, tv2,
                            **{**kw, "grad_scale": torch.tensor(0.5)})
    assert torch.equal(tp2, tp) and torch.equal(tv2, tv)


def _opt_params(seed=0):
    """Four parameters and three steps of gradients, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(7, 5), (5,), (3, 4, 2), (11,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(STEPS)]
    return init, grads


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_param"])
def test_adamw_step_matches_the_reference(fused):
    """Three steps of AdamW (weight decay on for parameters 0 and 2 only,
    so two groups; global-norm clip at 1.0) against the reference's eager
    AdamW.step and its per-parameter `_adam_step` (functional_update).
    fp32: 1e-6 absolute plus 1e-6 relative (the fused and the per-parameter
    formulas differ by rounding only)."""
    init, grads = _opt_params()
    decay = {0, 2}
    jparams = [JaxParameter(jnp.asarray(a)) for a in init]
    jnames = {jp.name for i, jp in enumerate(jparams) if i in decay}
    jopt = JaxAdamW(LR, parameters=jparams, weight_decay=0.05,
                    apply_decay_param_fun=lambda n: n in jnames,
                    grad_clip=JaxClip(1.0))
    fparams = [jnp.asarray(a) for a in init]
    fstate = jopt.init_state_tree(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    topt = AdamW(LR, parameters=tparams, weight_decay=0.05,
                 apply_decay_param_fun=lambda n: int(n.split("_")[1])
                 in decay, grad_clip=ClipGradByGlobalNorm(1.0))
    tflags.set_flags({"use_fused_adamw": fused})
    fused_adamw.fused_adamw.launches = 0
    try:
        for gs in grads:
            for jp, tp, g in zip(jparams, tparams, gs):
                jp.grad = paddle.to_tensor(g)
                tp.grad = torch.from_numpy(g.copy())
            jopt.step()
            fg = [g for _, g in JaxClip(1.0)(
                [(None, jnp.asarray(g)) for g in gs])]
            fg = [g._value for g in fg]
            fparams, fstate = jopt.functional_update(fparams, fg, fstate, LR)
            topt.step()
            topt.clear_grad()
    finally:
        tflags.set_flags({"use_fused_adamw": True})
    # the fused path launches one update per group per step (plain on CPU,
    # where no launch is counted)
    assert fused_adamw.fused_adamw.launches == 0
    assert len(topt._groups) == 2
    for i, tp in enumerate(tparams):
        for want in (jparams[i], fparams[i]):
            np.testing.assert_allclose(_np(tp), _np(want), atol=1e-6,
                                       rtol=1e-6)
        st, jst = topt._get_state(tp), jopt._get_state(jparams[i])
        for key in ("moment1", "moment2"):
            np.testing.assert_allclose(_np(st[key]), _np(jst[key]),
                                       atol=1e-6, rtol=1e-6)
        for key in ("beta1_pow", "beta2_pow"):
            assert st[key] == pytest.approx(float(jst[key]), rel=1e-7)
        assert st["wd_on"] == float(jst["wd_on"])


def test_adamw_groups_views_and_runs():
    """Parameters, gradients and moments become views of the group's flat
    buffers; a parameter without a gradient splits the group's run; the
    reference's clear_grad(set_to_zero=False) drops the gradients."""
    init, grads = _opt_params()
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = AdamW(LR, parameters=tparams)
    for tp, g in zip(tparams, grads[0]):
        tp.grad = torch.from_numpy(g.copy())
    opt.step()
    (group,) = opt._groups
    for tp, (a, b) in zip(tparams, group.bounds):
        assert tp.data_ptr() == group.p[a:b].data_ptr()
        assert tp.grad.data_ptr() == group.g[a:b].data_ptr()
        assert opt._get_state(tp)["moment1"].data_ptr() == \
            group.m[a:b].data_ptr()
    assert [r[:2] for r in opt._runs(group)] == [[0, group.p.numel()]]
    opt.clear_grad()
    assert float(group.g.abs().sum()) == 0.0 and tparams[0].grad is not None
    opt.clear_grad(set_to_zero=False)
    assert all(tp.grad is None for tp in tparams)
    for i in (0, 2, 3):
        tparams[i].grad = torch.from_numpy(grads[1][i].copy())
    before = tparams[1].detach().clone()
    opt.step()
    assert torch.equal(tparams[1].detach(), before)     # skipped
    runs = opt._runs(group)
    # params 0 | 2, 3: two runs; param 0 and params 2-3 now differ from
    # param 1 in their beta powers
    assert len(runs) == 2
    assert opt._get_state(tparams[1])["beta1_pow"] != \
        opt._get_state(tparams[0])["beta1_pow"]


# ------------------------------------------------------- the slice: GPT
@pytest.fixture(scope="module")
def gpt_state():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _gpt_pair(state):
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _ids(seed=1):
    return np.random.default_rng(seed).integers(
        0, GPTConfig.tiny().vocab_size, (2, SEQ)).astype(np.int32)


def test_gpt_forward_logits_and_loss_match(gpt_state):
    """One fp32 forward before any step: logits to 1e-4 absolute (fp32
    over two blocks), the loss to 1e-5 relative; both packages take flash
    attention at s = 128."""
    jm, tm = _gpt_pair(gpt_state)
    ids = _ids()
    want_logits = _np(jm(paddle.to_tensor(ids)))
    want_loss = float(jm(paddle.to_tensor(ids),
                         labels=paddle.to_tensor(ids)).numpy())
    tid = torch.from_numpy(ids.astype(np.int64))
    with torch.no_grad():
        got_logits = _np(tm(tid))
        got_loss = float(tm(tid, labels=tid))
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4, rtol=0)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert got_loss == pytest.approx(np.log(1024), abs=0.5)
    # state_dict keys and shapes are the reference's, key for key
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: v.shape for k, v in gpt_state.items()}


def _train_both(state, amp_on):
    jm, tm = _gpt_pair(state)
    ids = _ids()
    jopt = JaxAdamW(LR, parameters=jm.parameters(), weight_decay=0.01,
                    grad_clip=JaxClip(1.0))
    topt = AdamW(LR, parameters=tm.parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))

    def jloss(x):
        with paddle.amp.auto_cast(enable=amp_on, level="O1",
                                  dtype="bfloat16"):
            return jm(x, labels=x)

    def tloss(x):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
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
    jp = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tp = {k: _np(v) for k, v in tm.state_dict().items()}
    return jl, tl, jp, tp


def test_train_steps_match_the_reference_fp32(gpt_state):
    """Three fp32 steps: losses to 1e-5 relative. Parameters: every
    element within 0.1 lr and the mean absolute difference under 1e-7.
    Adam divides each first moment by the root of the second, so where a
    parameter's gradients nearly cancel from step to step, fp32 rounding
    differences in the gradients (1e-6 relative) move the element by a
    visible share of lr (at most 2 lr per step when the sign flips); the
    bulk of the elements agree to fp32 rounding."""
    jl, tl, jp, tp = _train_both(gpt_state, amp_on=False)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    diff = np.concatenate([np.abs(tp[k] - jp[k]).ravel() for k in jp])
    assert diff.max() <= 0.1 * LR
    assert diff.mean() <= 1e-7


def test_train_steps_match_the_reference_amp_o1(gpt_state):
    """Three amp O1 (bf16) steps: losses to 1e-3 relative, a quarter of
    one bf16 rounding (2**-8). The matmuls and attention round to bf16 in
    both packages, but not always the same values: GELU runs op by op in
    bf16 in the reference and in fp32 with one rounding in torch, so
    activations differ by a bf16 ulp here and there, and the mean over 254
    tokens of the loss averages that down."""
    jl, tl, _, _ = _train_both(gpt_state, amp_on=True)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


# ------------------------------------------------------------------ guards
def test_import_guard_walks_the_training_modules():
    code = (
        "import pkgutil, paddle_tpu_torch\n"
        "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
        "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("amp", "amp.state", "optimizer.optimizer",
                "optimizer.optimizers", "jit.trainer", "models.gpt",
                "nn.clip", "ops.gpu.flash_attention", "ops.gpu.fused_adamw",
                "io", "io.packing", "models.llama", "models.generation",
                "ops.gpu.fused_norm", "ops.gpu.rope",
                "tools.profile_training", "optimizer.lr",
                "observability.telemetry", "observability.flight_recorder",
                "observability.spans"):
        assert f"paddle_tpu_torch.{mod}" in names, mod
    # the packed slice's kernels are registered wrappers with counters
    from paddle_tpu_torch.ops.gpu import KERNEL_WRAPPERS
    for name in ("flash_seg_fwd", "flash_seg_dq", "flash_seg_dkv",
                 "rms_norm_bwd", "adamw_master"):
        assert isinstance(KERNEL_WRAPPERS[name].launches, int), name


def test_training_entry_points_raise_without_a_gpu(monkeypatch):
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    opt = AdamW(LR, parameters=tm.parameters())
    lm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    lopt = AdamW(LR, parameters=lm.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(tm, lambda x: tm(x, labels=x), opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(tm, lambda x: tm(x, labels=x), opt, nan_guard=True,
                  telemetry=True)
    # the packed Llama: model and step
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(lm, lambda x, s, y: lm(x, labels=y, segments=s), lopt)
    lcfg = LlamaConfig.tiny()
    lcfg.recompute = True
    assert LlamaForCausalLM(lcfg, device="cpu").config.recompute
    with pytest.raises(NotImplementedError, match="segments"):
        lm(torch.zeros(1, 4, dtype=torch.long), caches=[],
           segments=torch.zeros(1, 4, dtype=torch.int32))
    cfg = GPTConfig.tiny()
    cfg.use_rotary = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="segments"):
        tm(torch.zeros(1, 4, dtype=torch.long), caches=[],
           segments=torch.zeros(1, 4, dtype=torch.int32))


def test_serving_builds_no_autograd_graph():
    """Layers create trainable parameters (the Llama's too, by default); the
    serving engine still runs without building a graph."""
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    assert all(p.requires_grad for p in tm.parameters())
    lm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert all(p.requires_grad for p in lm.parameters())
    eng = ServingEngine(lm, device="cpu", max_slots=2, block_size=8,
                        prefill_chunk=16)
    out = eng.generate([[1, 2, 3, 4, 5], list(range(20))], max_new_tokens=3)
    assert [len(o) for o in out] == [5 + 3, 20 + 3]
    # a page written under autograd would carry a CopySlices graph
    for kp, vp in eng.pool.layers:
        assert not kp.requires_grad and kp.grad_fn is None
        assert not vp.requires_grad and vp.grad_fn is None
    assert all(p.grad is None for p in lm.parameters())
