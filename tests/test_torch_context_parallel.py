"""Context parallelism in the port (distributed/context_parallel.py: ring
and Ulysses attention over a sep group, the differentiable collectives,
the sequence utilities, GPT's `sequence_parallel`, TrainStep over dp x
sep) over gloo rank processes, held against the reference's
context_parallel.py in shard_maps over the conftest's 8-device CPU mesh.

Two rank worlds run while this process computes the reference (their
bodies are in tests/_torch_cp_ranks.py): world 2 (sep 2) and world 4 (sep
4, then dp 2 x sep 2). Each rank gets the same global arrays and takes
its shard; the shards' outputs and gradients are put back together here.

The reference's ring runs its Pallas chunks in interpret mode
(FLAGS_use_flash_attention and FLAGS_pallas_interpret, as
test_context_parallel.py's TestRingFlash runs them) for the causal ring
at sep 2, and its dense chunks elsewhere: the same arithmetic, and the
interpret mode's compiles would take most of the file's time (its
Ulysses takes its dense path at these shapes either way: s 64 is under
the flash gate's 128). The port's cases run with its flash chunks on and
off.

Tolerances, fp32 throughout (both sides compute in fp32, the chunks and
the merge in another order):
  * attention outputs and q/k/v gradients: 2e-6 absolute + 1e-5 relative
    (the worst element reads under 1.2e-6 against the reference, and
    against float64 dense attention on the whole sequence);
  * flash_attention_with_lse: o, lse and the gradients under a non-zero
    lse cotangent, 1e-5 absolute + 1e-5 relative;
  * the collectives and the sequence utilities: exact (they move bytes;
    the reduce-scatter adds two or four fp32 values, 1e-6);
  * tiny GPT (vocab 128, hidden 32, 1 layer, 4 heads, s 16): the loss
    1e-5 relative, every gradient 1e-6 absolute + 1e-4 relative against
    the reference at sep 2 and at sep 1 (also of the same loss taken on
    the gathered logits); the ranks bitwise equal; a loss on GPTModel's
    gathered hidden states (gradients up to ~10, where rotary fp32 is
    2e-4 off) within twice the plain fp32 model's largest error against
    float64;
  * three TrainSteps over dp 2 x sep 2 against the reference's sep=1
    TrainStep on the same global batches: losses 1e-5 relative,
    parameters 1e-5 absolute (lr 1e-4, as the data-parallel tests take
    it), and ring also against the reference's own dp 2 x sep 2
    TrainStep (GSPMD with its shard-mapped attention, as
    test_context_parallel.py runs it without mp; its `dp_axis=` form
    refuses that mesh on the CPU: its shard_map's context mesh does not
    match).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import _torch_cp_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.core import flags as jflags
from paddle_tpu.distributed import context_parallel as jcp
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.ops import api as japi
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.gpu import flash_attention as tflash

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

B, S, H, D = 2, 64, 4, 16
LR = 1e-4
ATT_ATOL, ATT_RTOL = 2e-6, 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    out = {k: rng.standard_normal((B, S, H, D)).astype(np.float32)
           for k in "qkvg"}
    n = 2
    out["x"] = rng.standard_normal((n, 3, 5)).astype(np.float32)
    out["y"] = rng.standard_normal((n, 3, 5)).astype(np.float32)
    out["c"] = rng.standard_normal((n, 3, 5)).astype(np.float32)
    out["a2a"] = rng.standard_normal((n, 2, 3, 4)).astype(np.float32)
    out["a2a_cot"] = rng.standard_normal((n, 2, 6, 2)).astype(np.float32)
    out["seq"] = np.stack([rng.standard_normal((2, 8, 3))] * n) \
        .astype(np.float32)
    for k, shape in (("ag_in", (2, 4, 3)), ("ag_cot", (2, 8, 3)),
                     ("rs_in", (2, 8, 3)), ("rs_cot", (2, 4, 3))):
        out[k] = rng.standard_normal((n,) + shape).astype(np.float32)
    return out


def _ids(rows, seed):
    return np.random.RandomState(seed).randint(0, 128, (rows, 16)) \
        .astype(np.int64)


def _jax_gpt(sp, rotary, state=None):
    paddle.seed(11)
    cfg = JaxGPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                       num_heads=4, max_position_embeddings=32,
                       hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                       sequence_parallel=sp, use_rotary=rotary)
    m = JaxGPT(cfg)
    if state is not None:
        m.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return m


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


class _Flags:
    """The reference's flash flags for a block, restored after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.saved = {k: jflags.get_flag(k)
                      for k in ("use_flash_attention", "pallas_interpret")}
        jflags.set_flags({"use_flash_attention": self.on,
                          "pallas_interpret": self.on})

    def __exit__(self, *exc):
        jflags.set_flags(self.saved)


ATT_CASES = [(mode, causal) for mode in ("ring", "ulysses")
             for causal in (True, False)]


def _ref_attention(inputs, n):
    """The reference's ring and Ulysses attention, causal and not, in one
    shard_map over n devices of the sep mesh (one compile for the four):
    each case's output and q/k/v gradients under the cotangent g. The
    ring at sep 2 runs its causal chunks through the Pallas kernels in
    interpret mode; the flags are read as the cases are traced."""
    q, k, v, g = (jnp.asarray(inputs[x]) for x in "qkvg")
    mesh = Mesh(np.array(jax.devices()[:n]), ("sep",))
    spec = P(None, "sep", None, None)
    fns = {"ring": jcp.ring_attention, "ulysses": jcp.ulysses_attention}

    def cases(*qkv):
        outs = []
        for i, (mode, causal) in enumerate(ATT_CASES):
            with _Flags(mode == "ring" and causal and n == 2):
                outs.append(fns[mode](*qkv[3 * i:3 * i + 3], "sep",
                                      causal=causal))
        return tuple(outs)

    f = jax.shard_map(cases, mesh=mesh, in_specs=(spec,) * 12,
                      out_specs=(spec,) * 4, check_vma=False)
    outs, vjp = jax.vjp(jax.jit(f), *(q, k, v) * 4)
    grads = vjp((g,) * 4)
    return {(mode, n, causal): dict(zip(
        ("o", "dq", "dk", "dv"),
        (np.asarray(t) for t in (outs[i],) + grads[3 * i:3 * i + 3])))
        for i, (mode, causal) in enumerate(ATT_CASES)}


def _ref_collectives(inputs):
    """lax.ppermute of a pair, lax.all_to_all and the reference's
    sequence utilities in one shard_map over two devices, each rank's
    inputs its row of the stacked arrays: the outputs and the inputs'
    gradients under the cotangents the ranks take."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("sep",))
    perm = [(0, 1), (1, 0)]

    def f(x, y, a, seq, agi, rsi):
        px, py = lax.ppermute((x[0], y[0]), "sep", perm)
        b = lax.all_to_all(a[0], "sep", split_axis=2, concat_axis=1,
                           tiled=True)
        outs = (px, py, b, jcp.scatter_seq(seq[0], "sep"),
                jcp.all_gather_seq(agi[0], "sep"),
                jcp.gather_seq(agi[0], "sep"),
                jcp.reduce_scatter_seq(rsi[0], "sep"))
        return tuple(t[None] for t in outs)

    sm = jax.shard_map(f, mesh=mesh, in_specs=(P("sep"),) * 6,
                       out_specs=(P("sep"),) * 7, check_vma=False)
    names = ("x", "y", "a2a", "seq", "ag_in", "rs_in")
    outs, vjp = jax.vjp(jax.jit(sm),
                        *(jnp.asarray(inputs[k]) for k in names))
    c = jnp.asarray(inputs["c"])
    grads = vjp((c, 2 * c, jnp.asarray(inputs["a2a_cot"]),
                 jnp.zeros_like(outs[3]), jnp.asarray(inputs["ag_cot"]),
                 jnp.zeros_like(outs[5]), jnp.asarray(inputs["rs_cot"])))
    out = dict(zip(("px", "py", "b", "scatter", "gather", "gather_alias",
                    "reduce_scatter"), (np.asarray(t) for t in outs)))
    out.update(zip(("gx", "gy", "ga", "gseq", "gather_grad",
                    "reduce_scatter_grad"), (np.asarray(t) for t in grads)))
    return out


def _ref_gpt(states, ids):
    """Loss, gradients and logits of the reference's tiny GPT at sep 1
    and, on a sep 2 mesh, with sequence_parallel ring and ulysses."""
    x = paddle.to_tensor(ids.astype(np.int32))

    def run(m):
        loss = m(x, labels=x)
        loss.backward()
        grads = {k: np.asarray(p.grad._value)
                 for k, p in m.named_parameters()}
        return {"loss": float(loss.item()), "grads": grads}

    out = {}
    with _Flags(False):
        for rotary in (False, True):
            m = _jax_gpt(None, rotary, states[rotary])
            out[(None, rotary)] = run(m)
            out[(None, rotary)]["logits"] = np.asarray(m(x).numpy())
        before = jdist.get_mesh()
        jdist.set_mesh(jdist.build_mesh(sep=2))
        try:
            for rotary in (False, True):
                for mode in ("ring", "ulysses"):
                    out[(mode, rotary)] = run(
                        _jax_gpt(mode, rotary, states[rotary]))
        finally:
            jdist.set_mesh(before)
    return out


def _ref_train(state, batches, mesh_kw):
    """Three reference TrainSteps: sep 1 (mesh_kw None), or GSPMD over
    build_mesh(**mesh_kw) with the ring."""
    from paddle_tpu.distributed.sharding_utils import (
        shard_batch, shard_model_parameters)

    before = jdist.get_mesh()
    mesh = None
    with _Flags(False):
        try:
            if mesh_kw:
                mesh = jdist.build_mesh(**mesh_kw)
                jdist.set_mesh(mesh)
            m = _jax_gpt("ring" if mesh else None, True, state)
            if mesh is not None:
                shard_model_parameters(m, mesh)
            opt = JaxAdamW(LR, parameters=m.parameters(), weight_decay=0.01,
                           grad_clip=JaxClip(1.0))
            step = JaxTrainStep(m, lambda x: m(x, labels=x), opt)
            losses = []
            for b in batches:
                x = paddle.to_tensor(b.astype(np.int32))
                if mesh is not None:
                    shard_batch(x, mesh, axes=("dp",))
                losses.append(float(step(x).numpy()))
            return {"losses": losses, "params": _state(m)}
        finally:
            jdist.set_mesh(before)


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    states = {rot: _state(_jax_gpt(None, rot)) for rot in (False, True)}
    ids = _ids(2, 0)
    batches = [_ids(4, s) for s in range(1, 4)]
    ctxs = {2: spawn(ranks.sep_world, args=(inputs, states, ids), nprocs=2,
                     backend="cpu", join=False),
            4: spawn(ranks.dp_sep_world,
                     args=(inputs, states[True], batches, LR), nprocs=4,
                     backend="cpu", join=False)}
    fast = paddle.get_flags(["jit_fast_dispatch"])
    paddle.set_flags({"jit_fast_dispatch": True})
    try:
        ref = {"attention": {**_ref_attention(inputs, 2),
                             **_ref_attention(inputs, 4)},
               "collectives": _ref_collectives(inputs),
               "gpt": _ref_gpt(states, ids),
               "train": _ref_train(states[True], batches, None)}
        ref["train_gspmd"] = _ref_train(states[True], batches,
                                        dict(dp=2, sep=2))
    finally:
        paddle.set_flags(fast)
    port = {n: ctx.join(300) for n, ctx in ctxs.items()}
    return inputs, ref, port


def _dense(inputs, causal):
    """The whole sequence's attention in float64, and its q/k/v
    gradients under the cotangent g."""
    q, k, v = (torch.from_numpy(inputs[x]).double().requires_grad_(True)
               for x in "qkv")
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    (o * torch.from_numpy(inputs["g"]).double()).sum().backward()
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


@pytest.mark.parametrize("n,causal", [(2, True), (2, False), (4, True),
                                      (4, False)])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_cp_attention_matches_the_reference(runs, mode, n, causal):
    """Each rank's output shard and its q/k/v gradients, put back
    together, against the reference's shard_map (its Pallas chunks in
    interpret mode for the ring at sep 2, its dense chunks at sep 4) and
    against float64 dense attention; the port's chunks through flash and
    through the composition alike."""
    inputs, ref, port = runs
    want = ref["attention"][(mode, n, causal)]
    exact = _dense(inputs, causal)
    for flash in (True, False):
        got = {k: np.concatenate([r["cases"][(mode, causal, flash)][k]
                                  for r in port[n][:n]], axis=1)
               for k in ("o", "dq", "dk", "dv")}
        for k in got:
            np.testing.assert_allclose(got[k], want[k], atol=ATT_ATOL,
                                       rtol=ATT_RTOL, err_msg=(k, flash))
            np.testing.assert_allclose(got[k], exact[k], atol=ATT_ATOL,
                                       rtol=ATT_RTOL, err_msg=(k, flash))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_matches_the_reference(causal):
    """The autograd Function's (o, lse) and the q/k/v gradients under
    cotangents of both outputs, against the reference's custom VJP in
    interpret mode (its blocks 32 x 32)."""
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((2, 2, 64)).astype(np.float32)
    scale = 0.25

    def ref(a, b, c):
        return jflash.flash_attention_with_lse(a, b, c, scale, causal, 32,
                                               32, True)

    (jo, jlse), vjp = jax.vjp(jax.jit(ref),
                              *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True)
                  for t in (q, k, v))
    o, lse = tflash.flash_attention_with_lse(tq, tk, tv, scale, causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 2, 64)
    torch.autograd.backward((o, lse), (torch.from_numpy(do),
                                       torch.from_numpy(dlse)))
    for got, want in ((o, jo), (lse, jlse), (tq.grad, jgrads[0]),
                      (tk.grad, jgrads[1]), (tv.grad, jgrads[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    # the lse cotangent matters: without it dq differs
    tq.grad = None
    o2, _ = tflash.flash_attention_with_lse(tq, tk, tv, scale, causal)
    o2.backward(torch.from_numpy(do))
    assert np.abs(tq.grad.numpy() - np.asarray(jgrads[0])).max() > 1e-3


def test_permute_and_alltoall_differentiate_as_the_reference(runs):
    """collective_permute of a pair (one message) and alltoall_single, with
    their gradients, against lax.ppermute and lax.all_to_all and their
    VJPs in a shard_map over two devices."""
    _, ref, port = runs
    want = ref["collectives"]
    for r, res in enumerate(port[2]):
        got = res["collectives"]
        for g, k in zip(got["permute"], ("px", "py", "gx", "gy")):
            np.testing.assert_array_equal(g, want[k][r])
        np.testing.assert_array_equal(got["alltoall"][0], want["b"][r])
        np.testing.assert_array_equal(got["alltoall"][1], want["ga"][r])


def test_sequence_utils_round_trip(runs):
    """scatter_seq, all_gather_seq (and its alias gather_seq) and
    reduce_scatter_seq on each rank's inputs, and the gather's and the
    reduce-scatter's gradients under each rank's cotangent, against the
    reference's functions and their VJPs in a shard_map over two devices
    (exact: bytes moved; the reduce-scatter adds two fp32 values)."""
    _, ref, port = runs
    want = ref["collectives"]
    for r, res in enumerate(port[2]):
        got = res["collectives"]
        np.testing.assert_array_equal(got["scatter"], want["scatter"][r])
        np.testing.assert_array_equal(got["gather"][0], want["gather"][r])
        np.testing.assert_array_equal(got["gather_alias"],
                                      want["gather_alias"][r])
        np.testing.assert_array_equal(got["gather"][1],
                                      want["gather_grad"][r])
        np.testing.assert_allclose(got["reduce_scatter"][0],
                                   want["reduce_scatter"][r], rtol=1e-6)
        np.testing.assert_array_equal(got["reduce_scatter"][1],
                                      want["reduce_scatter_grad"][r])


@pytest.mark.parametrize("rotary", [False, True], ids=["learned", "rotary"])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_gpt_loss_and_grads_match_the_reference(runs, mode, rotary):
    """model(ids, labels=ids).backward() on each of two sep ranks against
    the reference's model at sep 2 and at sep 1: the loss and every
    gradient, held by every rank (the ranks bitwise equal); a second,
    accumulating backward doubles them; without labels the logits are
    the whole sequence's, and the same loss taken on them gives the
    reference's sep=1 gradients; a loss on GPTModel's gathered hidden
    states gives the float64 gradients that loss has on a model that is
    not sequence-parallel, within twice that model's own fp32 error."""
    _, ref, port = runs
    ranks_out = [r["gpt"][(mode, rotary)] for r in port[2]]
    for want in (ref["gpt"][(mode, rotary)], ref["gpt"][(None, rotary)]):
        for got in ranks_out:
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
            assert set(got["grads"]) == set(want["grads"])
            for k, w in want["grads"].items():
                np.testing.assert_allclose(got["grads"][k], w, atol=1e-6,
                                           rtol=1e-4, err_msg=k)
                np.testing.assert_allclose(got["accumulated"][k], 2 * w,
                                           atol=2e-6, rtol=1e-4, err_msg=k)
    for k, g in ranks_out[0]["grads"].items():
        np.testing.assert_array_equal(ranks_out[1]["grads"][k], g)
    np.testing.assert_allclose(ranks_out[0]["logits"],
                               ref["gpt"][(None, rotary)]["logits"],
                               atol=1e-5, rtol=1e-5)
    for got in ranks_out:
        for k, w in ref["gpt"][(None, rotary)]["grads"].items():
            np.testing.assert_allclose(got["on_logits"][k], w, atol=1e-6,
                                       rtol=1e-4, err_msg=k)
        fp32, exact = got["hidden_dense"]
        bound = 2 * max(np.abs(fp32[k] - w).max() for k, w in exact.items())
        for k, w in exact.items():
            assert np.abs(got["hidden"][k] - w).max() <= bound, k


@pytest.mark.parametrize("mode", ["ring", "ulysses", None],
                         ids=["ring", "ulysses", "plain"])
def test_train_step_over_dp_and_sep_matches_the_reference(runs, mode):
    """Three TrainSteps over dp 2 x sep 2 (the batch split over dp, the
    gradients summed over sep and averaged over dp in one reduction over
    the joint group, the model's own hooks off, the clip after): every
    rank equal, and equal to the reference's sep=1 TrainStep on the same
    global batches; the ring also to the reference's dp 2 x sep 2 one. A
    GPT that is not sequence-parallel on the same mesh reduces over dp
    alone (its sep ranks computed the same gradients) and gives the same
    sep=1 step."""
    _, ref, port = runs
    res = port[4]
    assert [r["coord"]["dp"] for r in res] == [0, 0, 1, 1]
    assert [r["coord"]["sep"] for r in res] == [0, 1, 0, 1]
    assert all(r["joint"] == [0, 1, 2, 3] for r in res)
    runs_ = [r["train"][mode] for r in res]
    for got in runs_:
        assert got["reduce_world"] == (4 if mode else 2)
        assert not got["hooked"]
        assert got["parts"] == ["apply_s", "fwd_bwd_s", "reduce_wait_s"]
        assert got["losses"] == runs_[0]["losses"]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(v, runs_[0]["params"][k])
    wants = [ref["train"]] + ([ref["train_gspmd"]] if mode == "ring" else [])
    for want in wants:
        np.testing.assert_allclose(runs_[0]["losses"], want["losses"],
                                   rtol=1e-5)
        for k, w in want["params"].items():
            np.testing.assert_allclose(runs_[0]["params"][k], w, rtol=0,
                                       atol=1e-5, err_msg=k)
    assert runs_[0]["losses"][-1] != runs_[0]["losses"][0]


def test_the_reference_errors(runs):
    """Message for message: attention dropout under sequence parallelism
    and a bad mode when the model is built; a KV cache and packed
    segments at the forward; Ulysses with heads that do not divide and
    the registered op's bad mode (from the ranks)."""
    _, _, port = runs
    kw = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4,
              max_position_embeddings=32, hidden_dropout_prob=0.0)

    def both(exc, make_j, make_t):
        msgs = []
        for make in (make_j, make_t):
            with pytest.raises(exc) as e:
                make()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return msgs[0]

    assert "attention dropout" in both(
        ValueError,
        lambda: JaxGPT(JaxGPTConfig(sequence_parallel="ring",
                                    attention_dropout_prob=0.1, **kw)),
        lambda: GPTForCausalLM(GPTConfig(sequence_parallel="ring",
                                         attention_dropout_prob=0.1, **kw),
                               device="cpu"))
    assert "'ring' or 'ulysses'" in both(
        ValueError,
        lambda: JaxGPT(JaxGPTConfig(sequence_parallel="zigzag",
                                    attention_dropout_prob=0.0, **kw)),
        lambda: GPTForCausalLM(GPTConfig(sequence_parallel="zigzag",
                                         attention_dropout_prob=0.0, **kw),
                               device="cpu"))
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(sequence_parallel="ring",
                             attention_dropout_prob=0.0, **kw))
    tm = GPTForCausalLM(GPTConfig(sequence_parallel="ring",
                                  attention_dropout_prob=0.0, **kw),
                        device="cpu")
    ids = np.zeros((1, 8), np.int64)
    seg = np.zeros((1, 8), np.int32)
    assert "KV-cache" in both(
        NotImplementedError,
        lambda: jm.generate(paddle.to_tensor(ids.astype(np.int32)),
                            max_new_tokens=2),
        lambda: tm.generate(torch.from_numpy(ids), max_new_tokens=2))
    assert "segments=" in both(
        NotImplementedError,
        lambda: jm(paddle.to_tensor(ids.astype(np.int32)),
                   segments=paddle.to_tensor(seg)),
        lambda: tm(torch.from_numpy(ids), segments=torch.from_numpy(seg)))
    for res in port[2]:
        got = res["collectives"]
        assert got["heads_error"] == \
            "ulysses needs heads (3) divisible by axis size (2)"
        with pytest.raises(ValueError) as e:
            japi.sequence_parallel_attention(
                *(paddle.to_tensor(np.zeros((1, 4, 3, 8), np.float32))
                  for _ in range(3)), mode="zigzag")
        assert got["mode_error"] == str(e.value)
