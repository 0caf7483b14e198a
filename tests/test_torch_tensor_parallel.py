"""Tensor parallelism in the port (distributed/fleet/mp_layers.py, the
collective regions and `split`, mesh.annotate_param and
sharding_utils, the models at mp > 1, the global-norm clip and TrainStep
over mp and dp x mp) over gloo rank processes, held against the
reference on the conftest's 8-device CPU mesh.

Two rank worlds run while this process computes the reference (their
bodies are in tests/_torch_mp_ranks.py): world 2 (mp 2) and world 4 (dp
2 x mp 2, through fleet.init). Every rank gets the same global arrays and
the reference's whole weights, and takes its blocks
(models.convert.load_jax_state_dict by the parameters' specs); the
blocks of outputs and gradients are put back together here.

The reference's layers run in their shard_map form (weights per shard,
its collectives bound to the mp axis) in one shard_map over two devices;
the Megatron pair, its models and `split` under GSPMD on build_mesh(mp=2)
(the models after shard_model_parameters) and at mp 1; its TrainSteps on
one device. (Two of its shard_map forms do not run: ParallelCrossEntropy's
has no gradient, lax.pmax having no differentiation rule, and
RowSequenceParallelLinear's reduce_scatter over dimension -2 does not
lower.)

Tolerances, fp32 throughout (the same products, sums in another order
and over two partial blocks):
  * the layers and `split`: outputs and gradients 1e-5 relative + 1e-6
    of the array's largest magnitude (at least 1e-6) absolute (ParallelCrossEntropy's gradients, and its loss with
    `ignore_index`, against the reference's cross_entropy at mp 1: the
    shard_map form has neither a gradient, lax.pmax has no
    differentiation rule, nor an ignore_index);
  * GPT's head-major qkv: this rank's q, k and v within 1e-6 of the whole
    model's heads rank * H/n onwards;
  * tiny GPT (vocab 128, hidden 32, 2 layers, 4 heads, s 16) and tiny
    Llama (GQA: 4 heads over 2 key-value heads): the loss 1e-5 relative,
    every gathered gradient 1e-4 relative + 1e-6 of its largest magnitude
    (at least 1e-6) absolute, against the
    reference at mp 1 and under GSPMD at mp 2; the replicated
    parameters' gradients bitwise equal across the mp ranks;
  * a model built at mp 2 from a seed: bitwise the blocks of the mp-1
    model from that seed;
  * three TrainSteps (lr 1e-4, a global-norm clip of 0.05 that binds)
    at mp 2 (the plain clip and the hybrid optimizer's) and at dp 2 x mp
    2 against the reference's one-device TrainStep on the same global
    batches: losses 1e-5 relative, parameters 1e-5 absolute, as the CP
    and DP tests take them; the replicated parameters bitwise equal
    across the mp ranks after every step;
  * the Megatron pair in TrainStep (its norm and row bias summed over mp)
    against the reference's pair at mp 1: the same bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_mp_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.distributed.fleet import mp_layers as jmp
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

LR, CLIP, SEED = 1e-4, 0.05, 5
ATOL, RTOL = 1e-6, 1e-5
CFGS = {
    "gpt": dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                max_position_embeddings=32, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0),
    "llama": dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                  num_layers=2, num_heads=4, num_key_value_heads=2,
                  max_position_embeddings=32),
}


def _inputs():
    rng = np.random.default_rng(0)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ig = rng.integers(0, 32, (4, 6))
    ig[0, :3] = -100
    ig[2, 5] = -100
    return {"x8": r(4, 6, 8), "wc": r(8, 16), "bc": r(16),
            "cot_cg": r(4, 6, 16), "cot_cn": r(4, 6, 16),
            "x16": r(4, 6, 16), "wr": r(16, 8), "br": r(8),
            "cot_r": r(4, 6, 8), "ids": rng.integers(0, 32, (4, 6)),
            "we": r(32, 8), "cot_e": r(4, 6, 8), "logits": r(4, 6, 32),
            "labels": rng.integers(0, 32, (4, 6)), "labels_ig": ig,
            "cot_ce": r(4, 6), "xs": r(2, 8, 16), "w1": r(16, 32) * 0.3,
            "b1": r(32), "w2": r(32, 16) * 0.3, "b2": r(16),
            "cot_sp": r(2, 8, 16),
            "pair_batches": [r(2, 8, 16) for _ in range(3)]}


def _batches():
    return [np.random.RandomState(s).randint(0, 128, (4, 16))
            .astype(np.int64) for s in range(1, 4)]


class _NoMesh:
    """The reference's mesh unset for a block, restored after."""

    def __enter__(self):
        self.before = jdist.get_mesh()
        jdist.set_mesh(None)

    def __exit__(self, *exc):
        jdist.set_mesh(self.before)


def _set(layer, **values):
    for k, v in values.items():
        getattr(layer, k)._value = v


def _ref_layers(inputs):
    """Every reference mp layer in its shard_map form, in one shard_map
    over two devices: the outputs and, under the cotangents, the inputs'
    and weights' gradients (whole arrays)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    with _NoMesh():
        group = jdist.new_group(axis_name="mp")
        col_g = jmp.ColumnParallelLinear(8, 16, gather_output=True,
                                         mp_group=group)
        col_n = jmp.ColumnParallelLinear(8, 16, gather_output=False,
                                         mp_group=group)
        row = jmp.RowParallelLinear(16, 8, input_is_parallel=True,
                                    mp_group=group)
        emb = jmp.VocabParallelEmbedding(32, 8, mp_group=group)
        pce = jmp.ParallelCrossEntropy(mp_group=group)
        csp = jmp.ColumnSequenceParallelLinear(16, 32, mp_group=group)
        rsp = jmp.RowSequenceParallelLinear(32, 16, mp_group=group)
    ids, labels = (jnp.asarray(inputs[k]) for k in ("ids", "labels"))

    def f(xa, wa, ba, xb, wb, bb, xr, wr, br, we):
        with jcoll.axis_context("mp"):
            _set(col_g, weight=wa, bias=ba)
            _set(col_n, weight=wb, bias=bb)
            _set(row, weight=wr, bias=br)
            _set(emb, weight=we)
            return (col_g(Tensor(xa))._value, col_n(Tensor(xb))._value,
                    row(Tensor(xr))._value, emb(Tensor(ids))._value)

    def ce_sm(lg):
        with jcoll.axis_context("mp"):
            return pce(Tensor(lg), Tensor(labels))._value

    rep, last, cols, rows_ = P(), P(None, None, "mp"), P(None, "mp"), \
        P("mp", None)
    sm = jax.shard_map(
        f, mesh=mesh,
        in_specs=(rep, cols, P("mp"), rep, cols, P("mp"), last, rows_, rep,
                  rows_),
        out_specs=(rep, last, rep, rep), check_vma=False)
    names = ("x8", "wc", "bc", "x8", "wc", "bc", "x16", "wr", "br", "we")
    outs, vjp = jax.vjp(jax.jit(sm), *(jnp.asarray(inputs[k])
                                       for k in names))
    grads = [np.asarray(g) for g in vjp(tuple(jnp.asarray(inputs[k]) for k in (
        "cot_cg", "cot_cn", "cot_r", "cot_e")))]
    outs = [np.asarray(o) for o in outs]
    out = {("col", True): {"out": outs[0], "dx": grads[0],
                           "weight": grads[1], "bias": grads[2]},
           ("col", False): {"out": outs[1], "dx": grads[3],
                            "weight": grads[4], "bias": grads[5]},
           "row": {"out": outs[2], "dx": grads[6], "weight": grads[7],
                   "bias": grads[8]},
           "emb": {"out": outs[3], "weight": grads[9]}}

    # the Megatron pair as test_distributed.py runs it: GSPMD on
    # build_mesh(mp=2) (its shard_map form does not lower: a
    # reduce_scatter over dimension -2)
    def pair(xs, w1, b1, w2, b2):
        _set(csp, weight=w1, bias=b1)
        _set(rsp, weight=w2, bias=b2)
        return rsp(JF.gelu(csp(Tensor(xs)), approximate=True))._value

    before = jdist.get_mesh()
    jdist.set_mesh(jdist.build_mesh(mp=2))
    try:
        y, vjp = jax.vjp(jax.jit(pair), *(jnp.asarray(inputs[k]) for k in (
            "xs", "w1", "b1", "w2", "b2")))
        grads = [np.asarray(g) for g in vjp(jnp.asarray(inputs["cot_sp"]))]
    finally:
        jdist.set_mesh(before)
    out["sp"] = dict(zip(("dx", "w1", "b1", "w2", "b2"), grads),
                     out=np.asarray(y))
    # ParallelCrossEntropy's shard_map form has no gradient (lax.pmax has
    # no differentiation rule): its loss from the shard_map, and the loss
    # and logits' gradient of cross_entropy at mp 1
    pce_out = np.asarray(jax.jit(jax.shard_map(
        ce_sm, mesh=mesh, in_specs=(last,), out_specs=rep,
        check_vma=False))(jnp.asarray(inputs["logits"])))
    for key in ("labels", "labels_ig"):
        def ce(lg):
            return JF.cross_entropy(Tensor(lg), Tensor(jnp.asarray(
                inputs[key])), reduction="none",
                ignore_index=-100)._value.reshape(4, 6)

        o, vjp = jax.vjp(ce, jnp.asarray(inputs["logits"]))
        out[("pce", key)] = {
            "out": np.asarray(o), "shard_map_out": pce_out,
            "dlogits": np.asarray(vjp(jnp.asarray(inputs["cot_ce"]))[0])}
    return out


def _split_weights():
    rng = np.random.default_rng(1)
    return {"emb": {"weight": rng.standard_normal((32, 8))},
            "row": {"weight": rng.standard_normal((16, 8)),
                    "bias": rng.standard_normal(8)},
            "col": {"weight": rng.standard_normal((8, 16)),
                    "bias": rng.standard_normal(16)}}


def _ref_split(inputs, weights):
    """The reference's split in its three forms under GSPMD on
    build_mesh(mp=2), given the same weights."""
    out = {}
    before = jdist.get_mesh()
    jdist.set_mesh(jdist.build_mesh(mp=2))
    try:
        for key, x, size, op, axis in (
                ("emb", inputs["ids"], (32, 8), "embedding", 0),
                ("row", inputs["x16"], (16, 8), "linear", 0),
                ("col", inputs["x8"], (8, 16), "linear", 1)):
            x = paddle.to_tensor(x)
            jdist.split(x, size, operation=op, axis=axis, name=f"t_{key}")
            _set(jcoll._split_layer_cache[f"t_{key}"],
                 **{k: jnp.asarray(v, jnp.float32)
                    for k, v in weights[key].items()})
            out[key] = np.asarray(jdist.split(
                x, size, operation=op, axis=axis, name=f"t_{key}").numpy())
    finally:
        jdist.set_mesh(before)
    return out


def _jmodel(kind, state=None):
    paddle.seed(11)
    if kind == "gpt":
        m = JaxGPT(JaxGPTConfig(**CFGS["gpt"]))
    else:
        m = JaxLlama(JaxLlamaConfig(**CFGS["llama"]))
    if state is not None:
        m.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return m


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _ref_model(kind, state, ids):
    """Loss, gradients and logits of the reference's tiny model at mp 1
    and under GSPMD at mp 2 (shard_model_parameters)."""
    from paddle_tpu.distributed.sharding_utils import shard_model_parameters

    x = paddle.to_tensor(ids.astype(np.int32))

    def run(m):
        loss = m(x, labels=x)
        loss.backward()
        return {"loss": float(loss.item()),
                "grads": {k: np.asarray(p.grad._value)
                          for k, p in m.named_parameters()},
                "logits": np.asarray(m(x).numpy())}

    with _NoMesh():
        out = {1: run(_jmodel(kind, state))}
        mesh = jdist.build_mesh(mp=2)
        jdist.set_mesh(mesh)
        m = _jmodel(kind, state)
        shard_model_parameters(m, mesh)
        out[2] = run(m)
    return out


class _JPair(jnn.Layer):
    """The reference's Megatron pair with a LayerNorm before it (mp 1)."""

    def __init__(self):
        super().__init__()
        self.ln = jnn.LayerNorm(16)
        self.col = jmp.ColumnSequenceParallelLinear(16, 32)
        self.row = jmp.RowSequenceParallelLinear(32, 16)

    def forward(self, x):
        return self.row(JF.gelu(self.col(self.ln(x)), approximate=True))


def _ref_train(model, batches, clip, loss_of):
    opt = JaxAdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                   grad_clip=JaxClip(clip) if clip else None)
    step = JaxTrainStep(model, lambda x: loss_of(model, x), opt)
    losses = [float(step(paddle.to_tensor(b)).numpy()) for b in batches]
    return {"losses": losses, "params": _state(model)}


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    with _NoMesh():
        states = {kind: _state(_jmodel(kind)) for kind in ("gpt", "llama")}
        pair = _JPair()
        states["pair"] = _state(pair)
    states["split"] = _split_weights()
    ids = np.random.RandomState(0).randint(0, 128, (2, 16)).astype(np.int64)
    batches = _batches()
    ctxs = {2: spawn(ranks.mp_world, args=(inputs, states, CFGS, ids,
                                           batches, LR, CLIP, SEED),
                     nprocs=2, backend="cpu", join=False),
            4: spawn(ranks.dp_mp_world, args=(CFGS, states, batches, LR,
                                              CLIP),
                     nprocs=4, backend="cpu", join=False)}
    fast = paddle.get_flags(["jit_fast_dispatch"])
    paddle.set_flags({"jit_fast_dispatch": True})
    try:
        ref = {"layers": _ref_layers(inputs),
               "split": _ref_split(inputs, states["split"]),
               "gpt": _ref_model("gpt", states["gpt"], ids),
               "llama": _ref_model("llama", states["llama"], ids)}
        with _NoMesh():
            ref["train"] = _ref_train(
                _jmodel("gpt", states["gpt"]),
                [b.astype(np.int32) for b in batches], CLIP,
                lambda m, x: m(x, labels=x))
            pair = _JPair()
            pair.set_state_dict({k: paddle.to_tensor(v)
                                 for k, v in states["pair"].items()})
            ref["pair_train"] = _ref_train(
                pair, inputs["pair_batches"], None,
                lambda m, x: (m(x) * m(x)).mean())
    finally:
        paddle.set_flags(fast)
    port = {n: ctx.join(300) for n, ctx in ctxs.items()}
    return inputs, ref, port


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    """Within rtol of each value plus atol of the array's largest
    magnitude (at least atol): a sum's rounding grows with its terms."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=rtol,
                               err_msg=msg)


def _cat(res, key, axis):
    return np.concatenate([r[key] for r in res], axis=axis)


@pytest.mark.parametrize("gather", [True, False], ids=["gather", "local"])
def test_column_parallel_linear_matches_shard_map(runs, gather):
    """ColumnParallelLinear at mp 2 (with and without gather_output): the
    output, the replicated input's gradient (summed over the ranks by the
    copy region, the same on each) and the weight and bias blocks."""
    _, ref, port = runs
    want = ref["layers"][("col", gather)]
    res = [r["layers"][("col", gather)] for r in port[2]]
    out = res[0]["out"] if gather else _cat(res, "out", -1)
    _close(out, want["out"])
    for r in res:
        _close(r["dx"], want["dx"])
        if gather:
            np.testing.assert_array_equal(r["out"], res[0]["out"])
    _close(_cat(res, "weight", 1), want["weight"])
    _close(_cat(res, "bias", 0), want["bias"])


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["input_is_parallel", "whole_input"])
def test_row_parallel_linear_matches_shard_map(runs, parallel):
    """RowParallelLinear at mp 2: the all-reduced output (bias once) and
    the gradients; a whole input is split by the layer, and its gradient
    all-gathered, the reference's block-input gradient put together."""
    _, ref, port = runs
    want = ref["layers"]["row"]
    res = [r["layers"][("row", parallel)] for r in port[2]]
    dx = _cat(res, "dx", -1) if parallel else res[0]["dx"]
    _close(dx, want["dx"])
    for r in res:
        _close(r["out"], want["out"])
        _close(r["bias"], want["bias"])
    _close(_cat(res, "weight", 0), want["weight"])


def test_vocab_parallel_embedding_matches_shard_map(runs):
    _, ref, port = runs
    want = ref["layers"]["emb"]
    res = [r["layers"]["emb"] for r in port[2]]
    for r in res:
        _close(r["out"], want["out"])
    _close(_cat(res, "weight", 0), want["weight"])


@pytest.mark.parametrize("labels", ["labels", "labels_ig"])
def test_parallel_cross_entropy_matches_the_reference(runs, labels):
    """ParallelCrossEntropy over vocabulary blocks: each row's loss and
    the logits' gradient, against the reference's shard_map form (as
    test_distributed.py runs it: its loss only, that form has no
    gradient) and against its cross_entropy at mp 1, with and without
    ignore_index labels (ignored rows 0, no gradient)."""
    _, ref, port = runs
    want = ref["layers"][("pce", labels)]
    res = [r["layers"][("pce", labels)] for r in port[2]]
    for r in res:
        _close(r["out"], want["out"])
        if labels == "labels":
            _close(r["out"], want["shard_map_out"])
    _close(_cat(res, "dlogits", -1), want["dlogits"])
    if labels == "labels_ig":
        assert (res[0]["out"][0, :3] == 0).all()


def test_sequence_parallel_pair_matches_shard_map(runs):
    """ColumnSequenceParallelLinear -> GELU -> RowSequenceParallelLinear on
    sequence shards: the output shards, the input shards' gradients, the
    weight blocks' gradients and the row bias's, partial on each rank
    (marked sequence-parallel) and summed here."""
    _, ref, port = runs
    want = ref["layers"]["sp"]
    res = [r["layers"]["sp"] for r in port[2]]
    _close(_cat(res, "out", 1), want["out"])
    _close(_cat(res, "dx", 1), want["dx"])
    _close(_cat(res, "w1", 1), want["w1"])
    _close(_cat(res, "b1", 0), want["b1"])
    _close(_cat(res, "w2", 0), want["w2"])
    _close(sum(r["b2_partial"] for r in res), want["b2"])
    assert res[0]["marked"] == [False, False, False, True]


@pytest.mark.parametrize("form", ["emb", "row", "col"])
def test_split_matches_the_reference(runs, form):
    """collective.split (embedding; linear over the rows; over the
    columns, gathered) at mp 2 against the reference's split under GSPMD
    with the same weights; the per-name cache hands back one layer."""
    _, ref, port = runs
    for r in port[2]:
        got = r["split"][form]
        assert got["cached"]
        assert got["first_shape"] == list(ref["split"][form].shape)
        _close(got["out"], ref["split"][form])


def test_gpt_qkv_is_head_major(runs):
    """A contiguous block of qkv_proj's columns holds whole heads' q, k
    and v: this rank's 2 heads equal the whole model's heads 2r, 2r+1."""
    _, _, port = runs
    for r in port[2]:
        assert r["heads"]["heads_a_rank"] == 2
        assert all(d <= 1e-6 for d in r["heads"]["diff"])


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tiny_models_match_the_reference_at_mp_one_and_two(runs, kind):
    """Tiny GPT (cut at construction) and tiny Llama with GQA (built whole,
    then cut by shard_model_parameters) at mp 2: the loss, every gathered
    gradient and the gathered logits against the reference at mp 1 and
    under GSPMD at mp 2; the replicated parameters' gradients bitwise
    equal on the two ranks."""
    _, ref, port = runs
    res = [r[kind] for r in port[2]]
    for want in (ref[kind][1], ref[kind][2]):
        for got in res:
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
            assert set(got["grads"]) == set(want["grads"])
            for k, w in want["grads"].items():
                _close(got["grads"][k], w, rtol=1e-4, msg=k)
            _close(got["logits"], want["logits"], atol=1e-5)
    assert res[0]["replicated"]
    for k, g in res[0]["replicated"].items():
        np.testing.assert_array_equal(res[1]["replicated"][k], g)


def test_model_built_at_mp_two_holds_the_mp_one_blocks(runs):
    """GPTForCausalLM built under the mp 2 mesh from a seed, gathered,
    equals the mp-1 model from that seed bit for bit."""
    _, _, port = runs
    tdist.set_mesh(None)
    whole = GPTForCausalLM(GPTConfig(**CFGS["gpt"]), device="cpu",
                           seed=SEED)
    for r in port[2]:
        assert set(r["seeded"]) == set(whole.state_dict())
        for k, v in whole.state_dict().items():
            np.testing.assert_array_equal(r["seeded"][k], v.numpy(),
                                          err_msg=k)


def _train_matches(runs_, want):
    for got in runs_:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                       atol=1e-5, err_msg=k)
    assert runs_[0]["losses"][-1] != runs_[0]["losses"][0]


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid"])
def test_train_step_at_mp_two_matches_the_reference(runs, hybrid):
    """Three TrainSteps at mp 2 with a global-norm clip that binds (the
    plain ClipGradByGlobalNorm, and fleet's HybridParallelClipGrad through
    its factor): the norm is the global one, so the ranks scale alike and
    match the reference's one-device step; the replicated parameters are
    bitwise equal across the ranks after every step."""
    _, ref, port = runs
    res = [r["train"][hybrid] for r in port[2]]
    assert res[0]["clip"] == ("HybridParallelClipGrad" if hybrid
                              else "ClipGradByGlobalNorm")
    assert res[0]["mp_world"] == 2
    assert res[0]["parts"] == ["apply_s", "fwd_bwd_s", "square_sum_s"]
    _train_matches(res, ref["train"])
    for a, b in zip(res[0]["replicated"], res[1]["replicated"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_train_step_over_dp_and_mp_matches_the_reference(runs):
    """fleet.init at dp 2 x mp 2: the dp groups are the ranks of one mp
    position, shard_batch gives each dp rank its rows (the mp ranks of a
    dp rank the same), distributed_model wraps over the dp group, and
    three TrainSteps(dp_axis="dp") with the hybrid optimizer (gradients
    reduced over dp alone) match the reference's one-device step; every
    rank's replicated parameters bitwise equal after every step."""
    _, ref, port = runs
    res = port[4]
    assert [r["dp_group"] for r in res] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["mp_group"] for r in res] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    first = _batches()[0]
    for r in res:
        dp = r["dp_group"].index(r["rank"])
        assert r["wrapped"] == ["DataParallel", r["dp_group"]]
        np.testing.assert_array_equal(r["rows"]["ids"],
                                      first[2 * dp:2 * dp + 2])
        np.testing.assert_array_equal(r["rows"]["both"][0],
                                      r["rows"]["ids"])
    _train_matches([r["train"] for r in res], ref["train"])
    base = res[0]["train"]["replicated"]
    for r in res[1:]:
        for a, b in zip(r["train"]["replicated"], base):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_sequence_parallel_pair_in_train_step(runs):
    """LayerNorm and the Megatron pair at mp 2 through TrainStep, each rank
    on half of the sequence: the step sums the norm's and the row bias's
    partial gradients over mp (three parameters marked), and three steps
    match the reference's pair at mp 1."""
    _, ref, port = runs
    res = [r["pair_train"] for r in port[2]]
    assert res[0]["sp_params"] == 3
    _train_matches(res, ref["pair_train"])


def test_the_refusals(runs):
    """At mp 2: indivisible heads, intermediate size and vocabulary;
    sequence parallelism beside mp; ZeRO's zero_axis; a KV cache; an axis
    the mesh lacks (the reference's message); a dimension the axis does
    not divide (naming the parameter); the row side of the Megatron pair
    without input_is_parallel (the reference's message); a whole weight
    under an mp group of two."""
    _, _, port = runs
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.distributed import mesh as jmesh

    before = jdist.get_mesh()
    jdist.set_mesh(jdist.build_mesh(mp=2))
    try:
        with pytest.raises(ValueError) as e:
            jmesh.annotate_param(paddle.to_tensor(np.zeros(4, np.float32)),
                                 JP("xx"))
    finally:
        jdist.set_mesh(before)
    for r in port[2]:
        err = r["errors"]
        assert "num_heads (1)" in err["heads"]
        assert "vocab_size (127)" in err["vocab"]
        assert "intermediate_size (33)" in err["inter"]
        assert err["sep"].startswith("NotImplementedError") \
            and "sep x mp" in err["sep"]
        assert "sharding.py" in err["zero"] and "ZeRO" in err["zero"]
        assert "KV-cache" in err["cache"] and "mp > 1" in err["cache"]
        assert err["axis"] == f"ValueError: {e.value}"
        assert "w3" in err["annotate_dim"] and "dim 0" in err["annotate_dim"]
        assert err["rsp"] == (
            "NotImplementedError: RowSequenceParallelLinear under a bound "
            "mp axis requires input_is_parallel=True (split the input "
            "before the layer)")
        assert err["whole"].startswith("RuntimeError") \
            and "shard_model_parameters" in err["whole"]
