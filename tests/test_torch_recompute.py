"""Activation recomputation in the port against the JAX reference, on the
CPU.

paddle_tpu_torch.distributed.fleet.recompute and the models' recompute
branches: GPT and the packed Llama with recompute=True against the JAX
models with recompute (loss and gradients, fp32, the tolerances stated in
each test), recompute on against off in the port (bitwise, over three
TrainSteps), the amp state re-entered when the backward runs on another
thread (amp O1 and O2), dropout masks replayed from the models'
generators, every policy name, recompute_sequential against the
reference's, and an unknown policy.
"""
import importlib
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet import (recompute,
                                                recompute_sequential)
from paddle_tpu_torch.io import pack_examples
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_jax_state_dict)
from paddle_tpu_torch.nn import ColumnParallelLinear, Dropout
from paddle_tpu_torch.optimizer import AdamW

# the modules (the packages export functions of the same name)
jrec = importlib.import_module("paddle_tpu.distributed.fleet.recompute")
trec = importlib.import_module(
    "paddle_tpu_torch.distributed.fleet.recompute")

POLICIES = [None, "full", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "nothing_saveable",
            "everything_saveable"]


def _packed(vocab, seed=3):
    """One packed row of 128 tokens (the flash gate's length): four
    documents and a padding tail."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, n).astype(np.int32)
            for n in (30, 40, 20, 25)]
    return pack_examples(docs, 128)


def _pair(name, recompute_on=True):
    """The tiny JAX and port models of `name` with the same weights, both
    with recompute = `recompute_on`."""
    if name == "gpt":
        cfgs = JaxGPTConfig.tiny(), GPTConfig.tiny()
        jcls, tcls = JaxGPT, GPTForCausalLM
    else:
        cfgs = JaxLlamaConfig.tiny(), LlamaConfig.tiny()
        jcls, tcls = JaxLlama, LlamaForCausalLM
    for c in cfgs:
        c.recompute = recompute_on
    paddle.seed(0)
    jm = jcls(cfgs[0])
    jm.train()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tcls(cfgs[1], device="cpu", seed=1)
    load_jax_state_dict(tm, state)
    return jm, tm


def _batch(name, vocab):
    """(ids, segments or None, labels) for `name`."""
    if name == "gpt":
        ids = np.random.default_rng(2).integers(0, vocab, (2, 128)
                                                ).astype(np.int32)
        return ids, None, ids
    return _packed(vocab)


def _port_loss(model, ids, seg, labels):
    t = [None if a is None else torch.from_numpy(a.astype(np.int64))
         for a in (ids, seg, labels)]
    return model(t[0], labels=t[2], segments=t[1])


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["gpt", "llama_packed"])
def test_recompute_models_match_the_reference(name):
    """fp32, weights carried across, recompute on in both packages (the
    JAX model's Pallas kernels in interpret mode): the loss to 1e-5
    relative and every gradient within 1e-5 of the largest gradient
    element of its parameter plus 1e-7 (fp32 through two blocks; the
    non-recompute parity tests hold the same models' logits to 1e-4
    absolute)."""
    jm, tm = _pair(name)
    ids, seg, labels = _batch(name, tm.config.vocab_size)
    jargs = {"labels": paddle.to_tensor(labels)}
    if seg is not None:
        jargs["segments"] = paddle.to_tensor(seg)
    paddle.set_flags({"pallas_interpret": True})
    try:
        jloss = jm(paddle.to_tensor(ids), **jargs)
        jloss.backward()
    finally:
        paddle.set_flags({"pallas_interpret": False})
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    loss = _port_loss(tm, ids, seg, labels)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss.numpy()),
                                                 rel=1e-5)
    for n, g in _grads(tm).items():
        w = want[n]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-7)


def _train(model, batch, steps=3, **step_kw):
    opt = AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01)
    ids, seg, labels = batch
    if seg is None:
        step = TrainStep(model, lambda x, y: model(x, labels=y), opt,
                         device="cpu", **step_kw)
        args = (ids.astype(np.int64), labels.astype(np.int64))
    else:
        step = TrainStep(model, lambda x, s, y: model(x, labels=y,
                                                      segments=s), opt,
                         device="cpu", **step_kw)
        args = (ids.astype(np.int64), seg, labels.astype(np.int64))
    losses = [step(*args) for _ in range(steps)]
    return losses, opt


@pytest.fixture
def deterministic():
    """torch's deterministic CPU kernels: the embedding's backward
    (index_put_ with accumulate) sums duplicate rows across threads in
    whatever order they finish, so two identical CPU steps can differ in
    the last bit of the embedding's gradient, recompute or not."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("name", ["gpt", "llama_packed"])
def test_recompute_on_equals_off_bitwise(name, deterministic):
    """Three TrainSteps with recompute on and off from the same weights and
    batch: losses, parameters and both moments bitwise equal (the
    recomputed forward is the same ops on the same inputs, and
    non-reentrant checkpointing keeps the backward graph as it is)."""
    _, on = _pair(name, True)
    _, off = _pair(name, False)
    batch = _batch(name, on.config.vocab_size)
    lon, oon = _train(on, batch)
    loff, ooff = _train(off, batch)
    assert [float(x) for x in lon] == [float(x) for x in loff]
    for p, q in zip(on.parameters(), off.parameters()):
        assert torch.equal(p, q)
        for k in ("moment1", "moment2"):
            assert torch.equal(oon._get_state(p)[k], ooff._get_state(q)[k])


def _gpt(recompute_on, seed=0, **cfg_kw):
    cfg = GPTConfig.tiny()
    cfg.recompute = recompute_on
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    return GPTForCausalLM(cfg, device="cpu", seed=seed)


def _ids(seed=5, b=2, s=32):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, GPTConfig.tiny().vocab_size, (b, s)))


def _backward_on_a_thread(model, level, ids):
    """The loss under auto_cast(level) on this thread, its backward on
    another (where the thread-local amp state is the default one, as on
    the autograd engine's device thread); the gradients."""
    with amp.auto_cast(level=level, dtype="bfloat16"):
        loss = model(ids, labels=ids)
    err = []

    def run():
        try:
            loss.backward()
        except BaseException as e:  # surfaced below
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if err:
        raise err[0]
    return loss.detach(), _grads(model)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_state_is_reentered_for_a_backward_on_another_thread(
        level, monkeypatch, deterministic):
    """Recompute on equals recompute off bitwise (loss and every gradient)
    when the backward runs on another thread, under amp O1 and O2
    (decorated, bf16 parameters). Without the amp re-entry the
    recomputation runs in that thread's default state (no casts), and the
    gradients differ or the recomputed activations do not match what the
    forward saved: the same drive then fails."""
    models = {}
    for rc in (True, False):
        m = _gpt(rc)
        if level == "O2":
            amp.decorate(m, level="O2", dtype="bfloat16")
        models[rc] = m
    ids = _ids()
    loss_on, g_on = _backward_on_a_thread(models[True], level, ids)
    loss_off, g_off = _backward_on_a_thread(models[False], level, ids)
    assert torch.equal(loss_on, loss_off)
    for n in g_on:
        assert g_on[n].dtype == g_off[n].dtype
        assert torch.equal(g_on[n], g_off[n]), n
    # the same drive without the re-entry
    for p in models[True].parameters():
        p.grad = None
    monkeypatch.setattr(trec, "_AMP_FIELDS", ())
    try:
        _, g_bad = _backward_on_a_thread(models[True], level, ids)
    except Exception:   # the recomputed activations' dtypes differ
        return
    assert any(not torch.equal(g_bad[n], g_off[n]) for n in g_off)


def test_dropout_masks_are_replayed_from_the_models_generators(
        deterministic):
    """Hidden and attention dropout at 0.1, drawn from the GPT's own
    torch.Generator: three TrainSteps with recompute on equal recompute
    off bitwise (losses and parameters). A segment recomputed without
    preserve_rng_state draws fresh masks, and its gradients differ."""
    kw = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    on, off = _gpt(True, **kw), _gpt(False, **kw)
    ids = _ids().numpy()
    batch = (ids, None, ids)
    lon, _ = _train(on, batch)
    loff, _ = _train(off, batch)
    assert [float(x) for x in lon] == [float(x) for x in loff]
    for p, q in zip(on.parameters(), off.parameters()):
        assert torch.equal(p, q)

    gen = torch.Generator().manual_seed(3)
    block = torch.nn.Sequential(ColumnParallelLinear(8, 8),
                                Dropout(0.5, generator=gen))
    torch.nn.init.normal_(block[0].weight, generator=gen)
    x = torch.randn(4, 8, generator=gen)
    grads = {}
    for preserve in (True, False, None):
        gen.manual_seed(11)
        block.zero_grad()
        if preserve is None:
            out = block(x)
        else:
            out = recompute(block, x, preserve_rng_state=preserve)
        out.square().sum().backward()
        grads[preserve] = block[0].weight.grad.clone()
    assert torch.equal(grads[True], grads[None])
    assert not torch.equal(grads[False], grads[None])


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_gives_the_same_gradients(policy, deterministic):
    """Each policy name (the reference's recompute.py:31-39) gives the tiny
    GPT the no-recompute gradients bitwise. What it keeps shows in the
    matrix products the backward runs: without recompute, the 18 products
    of the gradients; with full recompute 6 more, the first three of each
    of the two blocks (qkv, out, fc_in; fc_out's output is saved by no
    later op, so the non-reentrant checkpoint stops its recomputation
    before it); with the dots policies and everything_saveable none (each
    block's products are 2-D, with no batch dimension, and kept)."""
    ids = _ids()

    def backward(model):
        loss = model(ids, labels=ids)
        counter = _CountMM()
        with counter:
            loss.backward()
        return counter.mm

    ref = _gpt(False)
    base = backward(ref)
    model = _gpt(True, recompute_policy=policy)
    mm = backward(model)
    for n, g in _grads(model).items():
        assert torch.equal(g, dict(ref.named_parameters())[n].grad), n
    assert base == 18
    assert mm == base + {None: 6, "full": 6, "nothing_saveable": 6
                         }.get(policy, 0)


def test_recompute_sequential_matches_the_reference():
    """Four Linear+Tanh layers in two recomputed segments, fp32, the same
    weights: output and gradients (input and weights) to 1e-5 relative and
    1e-6 absolute against the reference's recompute_sequential (XLA and
    torch sum the 8-term products in other orders: a few fp32 roundings
    over four layers)."""
    rng = np.random.default_rng(6)
    ws = [rng.standard_normal((8, 8)).astype(np.float32) * 0.5
          for _ in range(4)]
    x = rng.standard_normal((3, 8)).astype(np.float32)

    jl = []
    for w in ws:
        lin = paddle.nn.Linear(8, 8)
        lin.weight.set_value(paddle.to_tensor(w))
        lin.bias.set_value(paddle.to_tensor(np.zeros(8, np.float32)))
        jl += [lin, paddle.nn.Tanh()]
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jrec.recompute_sequential({"segments": 2}, jl, jx)
    jout.sum().backward()

    tl = []
    for w in ws:
        lin = ColumnParallelLinear(8, 8)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
        tl += [lin, torch.nn.Tanh()]
    tx = torch.from_numpy(x).requires_grad_()
    tout = recompute_sequential({"segments": 2}, tl, tx)
    tout.sum().backward()

    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout.numpy()), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-6)
    for t, j in zip(tl[::2], jl[::2]):
        np.testing.assert_allclose(t.weight.grad.numpy(),
                                   np.asarray(j.weight.grad.numpy()),
                                   rtol=1e-5, atol=1e-6)


def test_unknown_policy_raises_as_the_reference():
    lin = ColumnParallelLinear(4, 4)
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(lin, torch.randn(2, 4), policy="most_things")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        jrec.recompute(paddle.nn.Linear(4, 4),
                       paddle.to_tensor(np.ones((2, 4), np.float32)),
                       policy="most_things")


def test_recompute_builds_on_the_cpu_and_runs_only_in_training():
    """recompute=True builds on the CPU for both models; in eval mode the
    forward is the plain one (no checkpoint), as the reference's
    `self.training` gate makes it."""
    cfg = LlamaConfig.tiny()
    cfg.recompute = True
    lm = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    calls = []
    orig = trec._ckpt.checkpoint

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    trec._ckpt.checkpoint = spy
    try:
        lm(ids, labels=ids)
        assert len(calls) == cfg.num_layers
        lm.eval()
        with torch.no_grad():
            lm(ids)
        assert len(calls) == cfg.num_layers
    finally:
        trec._ckpt.checkpoint = orig
