"""Pipeline parallelism in the port (distributed/pipeline.py: the 1F1B,
F-then-B and interleaved engines; distributed/fleet/pipeline_parallel.py:
LayerDesc, SharedLayerDesc, PipelineLayer, PipelineParallel.train_batch;
GPT's and Llama's pipeline_descs; fleet.distributed_model at pp_degree >
1; the pp-global square-sum of the clip) over gloo rank processes, held
against the reference on the conftest's 8-device CPU mesh.

Two rank worlds run while this process computes the reference (their
bodies are in tests/_torch_pp_ranks.py): world 4 (pp 4, then dp 2 x pp 2,
then pp 2 x mp 2, then pp beside sep, refused) and world 2 (pp 2). Each
rank holds only its stage's block (beside mp, its mp block of it; beside
dp, it trains on its rows of the global batch). A child process computes
the reference's engines meanwhile (`_child_refs`), this one its
layer-level pipelines.

Tolerances (fp32), the reference's own (tests/test_pipeline.py):
  * the engines on the reference's rigs: the loss 1e-5 relative; each
    rank's d_stage block, d_loss, d_shared and d_xs 1e-4 relative + 1e-6
    absolute, against the reference's sequential value_and_grad in every
    case and against the reference's engine in one case of each engine
    and shape family (its own tests hold its engines to the same
    sequential program);
  * train_batch against the reference's PipelineParallel on the same
    weights and batch: the loss 1e-5 relative, every state_dict() entry
    1e-4 relative + 1e-6 absolute;
  * the clip's global square-sum against the reference model's whole
    gradient: 1e-5 relative (the tied ends counted once a stage would be
    far off). The GPT and Llama cases run AdamW with epsilon 1, so the
    update follows the clipped gradient's scale and the parameters see
    the clip too.

The dp 2 x pp 2 and pp 2 x mp 2 runs are held, at the same tolerances,
to the reference's train_batch on the same weights and global batch as
the pp 2 (LMs) and dp 2 x pp 4 (block model) runs above. The
reference's value does not depend on its mesh: its PipelineParallel
gives the same loss, bit for bit, at pp 2, pp 2 x mp 2, dp 2 x pp 2 and
dp 2 x pp 2 x mp 2 on the GPT and the Llama, and its own tests hold
every mesh to one sequential program;
tests/test_torch_hybrid_parallel.py runs it at dp 2 x pp 2 x mp 2
itself. Beside dp the replicas must be bitwise equal, beside mp each
pair's whole (replicated) entries.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_pp_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.fleet.pipeline_parallel import (
    LayerDesc as JaxLayerDesc, PipelineLayer as JaxPipelineLayer,
    PipelineParallel as JaxPipelineParallel,
    SharedLayerDesc as JaxSharedLayerDesc)
from paddle_tpu.distributed.pipeline import (pipeline_1f1b,
                                             pipeline_fthenb,
                                             pipeline_interleave)
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet import PipelineLayer, PipelineParallel
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from test_pipeline import _EngineRig, _InterleaveRig, _pp_mesh

LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
M = 4
GPT = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
           max_position_embeddings=32, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0)
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
             num_key_value_heads=2, intermediate_size=128,
             max_position_embeddings=32)
# AdamW with epsilon 1: the update is lr * m / (sqrt(v) + 1), about lr *
# the clipped gradient, so the parameters show the clip's factor
LM_SPEC = dict(lr=0.5, eps=1.0, clip=0.05, M=M)
SMALL_SPEC = dict(lr=1e-2, d=8, vocab=16, M=M)
# (kind, S, V, M) of each engine case; the ones marked also run the
# reference's engine
CASES4 = {("1F1B", 6): True, ("1F1B", 3): False, ("1F1B", 1): False,
          ("FThenB", 6): False, ("FThenB", 3): True, ("FThenB", 1): False,
          ("Interleave", 4, 2, 8): True, ("Interleave", 4, 2, 6): False,
          ("Interleave", 4, 1, 6): False, ("tied",): True}
CASES2 = {("1F1B", 2, 4): False, ("Interleave", 2, 3, 5): False}


# the LMs of the pp 2 x mp 2 runs (world 4); the first three also at pp 2
# (world 2)
LM_KINDS = ("gpt", "gpt_untied", "llama", "llama_tied")


def _lm_spec(kind):
    """(family, port config, the reference's weights) of an LM kind."""
    if kind.startswith("llama"):
        cfg = dict(LLAMA, tie_word_embeddings=kind == "llama_tied")
        return "llama", cfg, _jax_state(_jlm(kind))
    return "gpt", dict(GPT, tie_word_embeddings=kind != "gpt_untied"), \
        _jax_state(_jlm(kind))


class _Strat:
    def __init__(self, **cfg):
        self.pipeline_configs = cfg


def _tied_rig():
    """tests/test_pipeline.py's tied-embedding rig (S 4, V 2, M 6)."""
    S, V, M_, mb, seqlen, d, vocab = 4, 2, 6, 2, 4, 8, 16
    rng = np.random.RandomState(0)
    D = S * V
    Wg = jnp.asarray(rng.randn(D, d, d) * 0.3)
    bg = jnp.asarray(rng.randn(D, d) * 0.1)
    perm = [(i % V) * S + i // V for i in range(D)]
    sp = {"W": Wg[np.asarray(perm)], "b": bg[np.asarray(perm)]}
    shared = {"emb": jnp.asarray(rng.randn(vocab, d) * 0.5)}
    lp = {"bias": jnp.asarray(rng.randn(vocab) * 0.1)}
    ids = jnp.asarray(rng.randint(0, vocab, (M_, mb, seqlen)), jnp.int32)
    labels = jnp.asarray(rng.randint(0, vocab, (M_, mb, seqlen)), jnp.int32)
    stage_fn = lambda p, x: jnp.tanh(x @ p["W"] + p["b"])  # noqa: E731
    pre_fn = lambda sh, x: sh["emb"][x]  # noqa: E731
    post_fn = lambda sh, y: y @ sh["emb"].T  # noqa: E731

    def loss_fn(lp_, logits, lab):
        logits = logits + lp_["bias"]
        lse = jax.nn.logsumexp(logits, -1)
        tok = jnp.take_along_axis(logits, lab[..., None], -1)[..., 0]
        return jnp.mean(lse - tok)

    def seq():
        def total(Wg_, bg_, sh_, lp_):
            tot = 0.0
            for m in range(M_):
                h = pre_fn(sh_, ids[m])
                for g in range(D):
                    h = stage_fn({"W": Wg_[g], "b": bg_[g]}, h)
                tot = tot + loss_fn(lp_, post_fn(sh_, h), labels[m]) / M_
            return tot
        loss, (rW, rb, rsh, rlp) = jax.value_and_grad(
            total, argnums=(0, 1, 2, 3))(Wg, bg, shared, lp)
        p = np.asarray(perm)
        return {"loss": loss, "d_sp": {"W": rW[p], "b": rb[p]},
                "d_sh": rsh, "d_lp": rlp}

    def engine():
        loss, d_sp, d_sh, d_lp, _ = pipeline_interleave(
            stage_fn, loss_fn, _pp_mesh(S), S, sp, lp, ids, labels,
            n_virtual=V, pre_fn=pre_fn, post_fn=post_fn,
            shared_params=shared)
        return {"loss": loss, "d_sp": d_sp, "d_sh": d_sh, "d_lp": d_lp}

    case = {"kind": "tied", "S": S, "V": V, "sp": sp, "lp": lp,
            "sh": shared, "xs": ids, "labels": labels}
    return case, seq, engine


def _engine_case(key):
    """(the rank's case, the sequential reference, the reference engine)
    of an engine case key; results in stacked order (i = r*V + v)."""
    kind = key[0]
    if kind == "tied":
        return _tied_rig()
    if kind == "Interleave":
        S, V, M_ = key[1:]
        rig = _InterleaveRig(S=S, V=V, M=M_)
        p = np.asarray(rig.perm)

        def seq():
            loss, (rW, rb, rlp, rxs) = rig.reference()
            return {"loss": loss, "d_sp": {"W": rW[p], "b": rb[p]},
                    "d_lp": rlp, "d_xs": rxs}

        def engine():
            loss, d_sp, _, d_lp, d_xs = pipeline_interleave(
                rig.stage_fn, rig.loss_fn, _pp_mesh(S), S, rig.sp, rig.lp,
                rig.xs, rig.labels, n_virtual=V)
            return {"loss": loss, "d_sp": d_sp, "d_lp": d_lp, "d_xs": d_xs}
    else:
        S, M_ = (key[1], key[2]) if len(key) == 3 else (4, key[1])
        V = 1
        rig = _EngineRig(S=S, M=M_)

        def seq():
            loss, (dsp, dlp, dxs) = rig.reference()
            return {"loss": loss, "d_sp": dsp, "d_lp": dlp, "d_xs": dxs}

        def engine():
            fn = pipeline_1f1b if kind == "1F1B" else pipeline_fthenb
            loss, d_sp, d_lp, d_xs = fn(rig.stage_fn, rig.loss_fn,
                                        _pp_mesh(S), S, rig.sp, rig.lp,
                                        rig.xs, rig.labels)
            return {"loss": loss, "d_sp": d_sp, "d_lp": d_lp, "d_xs": d_xs}
    case = {"kind": kind, "S": S, "V": V, "sp": rig.sp, "lp": rig.lp,
            "xs": rig.xs, "labels": rig.labels}
    return case, seq, engine


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree if isinstance(tree, (str, int)) else np.asarray(tree)


def _jax_state(layer):
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in layer.state_dict().items()}


class _Mesh:
    """The reference's mesh set for a block, restored after."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.before = jdist.get_mesh()
        jdist.set_mesh(self.mesh)

    def __exit__(self, *exc):
        jdist.set_mesh(self.before)


def _jlm(kind, seed=3):
    paddle.seed(seed)
    if kind.startswith("llama"):
        return JaxLlama(JaxLlamaConfig(
            **LLAMA, tie_word_embeddings=kind == "llama_tied"))
    cfg = dict(GPT, tie_word_embeddings=kind != "gpt_untied")
    return JaxGPT(JaxGPTConfig(**cfg))


def _ref_lm(kind, batch):
    """The reference's PipelineParallel over GPT or Llama's pipeline_descs
    at pp 2: the layer's state after copy_weights, one train_batch's loss
    and state."""
    ids = batch[0].astype(np.int32)
    with _Mesh(jdist.build_mesh(pp=2)):
        descs, loss_fn, copy_weights = _jlm(kind).pipeline_descs()
        pl = JaxPipelineLayer(descs, num_stages=2, loss_fn=loss_fn)
        copy_weights(pl)
        copied = _jax_state(pl)
        pp = JaxPipelineParallel(pl, strategy=_Strat(accumulate_steps=M))
        opt = JaxAdamW(LM_SPEC["lr"], epsilon=LM_SPEC["eps"],
                       parameters=pp.parameters(), weight_decay=0.01,
                       grad_clip=JaxClip(LM_SPEC["clip"]))
        loss = pp.train_batch(
            (paddle.to_tensor(ids), paddle.to_tensor(ids)), opt)
        return {"copied": copied, "loss": float(loss.numpy()),
                "state": _jax_state(pp)}


def _whole_square_sum(kind, cfg_kw, state, batch):
    """The square-sum of the whole model's gradient of the batch's mean
    loss (every microbatch has as many targets), from the port at world 1
    on the reference's weights (the tests of the models hold it to the
    reference)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    model = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu") \
        if kind == "llama" else GPTForCausalLM(GPTConfig(**cfg_kw),
                                               device="cpu")
    load_jax_state_dict(model, state)
    ids = torch.from_numpy(batch[0])
    model(ids, labels=ids).backward()
    return sum(float(p.grad.double().square().sum())
               for p in model.parameters())


class _JBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc = jnn.Linear(d, d)

    def forward(self, x):
        from paddle_tpu.ops import api

        return api.tanh(self.fc(x))


def _jmse(out, label):
    from paddle_tpu.ops import api

    return api.mse_loss(out, label)


def _jce(out, label):
    from paddle_tpu.ops import api

    return api.cross_entropy(out, label)


def _jhead(layer, x):
    from paddle_tpu.ops import api

    return api.matmul(x, layer.weight, transpose_y=True)


def _ref_small(kind, batch):
    """The reference's block model (pp 4 on build_mesh(dp=2, pp=4), its own
    test's mesh) or tied-embedding model (S 4, V 2): its initial
    PipelineLayer state, and a function that runs one train_batch and
    returns its loss and state."""
    d, vocab, S, V = SMALL_SPEC["d"], SMALL_SPEC["vocab"], 4, 2
    paddle.seed(7)
    np.random.seed(7)
    if kind == "block":
        mesh = jdist.build_mesh(dp=2, pp=S)
        layers, loss_fn, cfg, nv = [_JBlock(d) for _ in range(S)], _jmse, \
            dict(accumulate_steps=M, schedule="1F1B"), 1
    else:
        mesh = jdist.build_mesh(pp=S)
        layers = [JaxSharedLayerDesc("embed", jnn.Embedding, None, "weight",
                                     vocab, d)]
        layers += [JaxLayerDesc(_JBlock, d) for _ in range(S * V)]
        layers += [JaxSharedLayerDesc("embed", jnn.Embedding, _jhead,
                                      "weight", vocab, d)]
        loss_fn, cfg, nv = _jce, dict(accumulate_steps=M,
                                      virtual_pp_degree=V), V
    with _Mesh(mesh):
        pl = JaxPipelineLayer(layers, num_stages=S, loss_fn=loss_fn,
                              num_virtual_pipeline_stages=nv)

    def train():
        with _Mesh(mesh):
            pp = JaxPipelineParallel(pl, strategy=_Strat(**cfg))
            opt = JaxAdamW(SMALL_SPEC["lr"], parameters=pp.parameters(),
                           weight_decay=0.01)
            loss = pp.train_batch(
                tuple(paddle.to_tensor(b) for b in batch), opt)
            return {"loss": float(loss.numpy()), "state": _jax_state(pp)}
    return _jax_state(pl), train


def _batches():
    rng = np.random.RandomState(5)
    d, vocab = SMALL_SPEC["d"], SMALL_SPEC["vocab"]
    block = (rng.randn(8, d).astype(np.float32),
             rng.randn(8, d).astype(np.float32))
    tied = (rng.randint(0, vocab, (8, 4)).astype(np.int64),
            rng.randint(0, vocab, (8, 4, 1)).astype(np.int64))
    ids = rng.randint(0, GPT["vocab_size"], (8, 16)).astype(np.int64)
    return block, tied, (ids, ids)


def _child_refs(path):
    """The engines' references, written to `path` as a pickle: run in a
    child process (`_start_child`), so their compiles overlap the
    layer-level references of this process (one process's tracing holds
    the GIL)."""
    fast = paddle.get_flags(["jit_fast_dispatch"])
    paddle.set_flags({"jit_fast_dispatch": True})
    try:
        out = {"engines": {}}
        for k, (_, seq, engine) in _cases().items():
            out["engines"][k] = {"seq": _np_tree(seq())}
            if {**CASES4, **CASES2}[k]:
                out["engines"][k]["engine"] = _np_tree(engine())
    finally:
        paddle.set_flags(fast)
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _start_child(path):
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [%r, %r]; import conftest; "
            "import test_torch_pipeline as t; t._child_refs(%r)"
            % (here, os.path.dirname(here), path))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def _cases():
    return {k: _engine_case(k) for k in {**CASES4, **CASES2}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs = tmp_path_factory.mktemp("pp") / "refs.pkl"
    fast = paddle.get_flags(["jit_fast_dispatch"])
    paddle.set_flags({"jit_fast_dispatch": True})
    child = _start_child(str(refs))
    try:
        cases = _cases()
        block_b, tied_b, lm_b = _batches()
        with _Mesh(None):
            lms = {k: _lm_spec(k) for k in LM_KINDS}
        block_state, block_train = _ref_small("block", block_b)
        tied_state, tied_train = _ref_small("tied", tied_b)
        np_case = {k: _np_tree(c[0]) for k, c in cases.items()}
        ctxs = {
            4: spawn(ranks.world4, args=(
                {k: np_case[k] for k in CASES4}, block_state, tied_state,
                block_b, tied_b, SMALL_SPEC, lms, lm_b, LM_SPEC), nprocs=4,
                backend="cpu", join=False),
            2: spawn(ranks.world2, args=(
                {k: np_case[k] for k in CASES2},
                {k: lms[k] for k in LM_KINDS[:3]}, [lm_b], LM_SPEC),
                nprocs=2, backend="cpu", join=False)}
        ref = {"lm": {k: _ref_lm(k, lm_b) for k in lms},
               "block": block_train(), "tied": tied_train()}
        for k, (kind, cfg_kw, state) in lms.items():
            ref["lm"][k]["square_sum"] = _whole_square_sum(kind, cfg_kw,
                                                           state, lm_b)
        _, err = child.communicate(timeout=300)
        if child.returncode:
            raise RuntimeError(f"the reference child failed:\n"
                               f"{err.decode()[-4000:]}")
        with open(refs, "rb") as f:
            ref.update(pickle.load(f))
    finally:
        paddle.set_flags(fast)
        if child.poll() is None:
            child.kill()
    port = {n: ctx.join(300) for n, ctx in ctxs.items()}
    return {"ref": ref, "port": port}


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def _block_rows(tree, r, V):
    return {k: np.asarray(v)[r * V:(r + 1) * V] for k, v in tree.items()}


@pytest.mark.parametrize("key", list(CASES4) + list(CASES2),
                         ids=lambda k: "-".join(map(str, k)))
def test_engine_matches_the_reference(runs, key):
    """Each rank's d_stage block, and the whole loss, d_loss, d_shared and
    d_xs on every rank, against the reference's sequential value_and_grad
    (and its engine where it ran)."""
    world = 4 if key in CASES4 else 2
    ref = runs["ref"]["engines"][key]
    V = key[2] if key[0] == "Interleave" else (2 if key[0] == "tied" else 1)
    for r, res in enumerate(runs["port"][world]):
        got = res["engines"][key]
        for name, want in ref.items():
            _close(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=0,
                   msg=name)
            for k, w in _block_rows(want["d_sp"], r, V).items():
                _close(got["d_sp"][k], w, msg=f"{name} d_sp {k} rank {r}")
            for k, w in want["d_lp"].items():
                _close(got["d_lp"][k], w, msg=f"{name} d_lp {k}")
            if "d_sh" in want:
                for k, w in want["d_sh"].items():
                    _close(got["d_sh"][k], w, msg=f"{name} d_sh {k}")
            if "d_xs" in want:
                _close(got["d_xs"], want["d_xs"], msg=f"{name} d_xs")


@pytest.mark.parametrize("key", [("1F1B", 6), ("FThenB", 6),
                                 ("Interleave", 4, 2, 8),
                                 ("Interleave", 2, 3, 5)],
                         ids=lambda k: "-".join(map(str, k)))
def test_engine_schedule_counts(runs, key):
    """The reference's tick arithmetic on every rank: M*V forward and
    backward slots, two handoffs a tick (F-then-B: one each way a tick),
    and the in-flight bound: 1F1B holds at most S - r microbatch graphs
    (its warm-up), F-then-B all M."""
    world = 4 if key in CASES4 else 2
    for r, res in enumerate(runs["port"][world]):
        st = res["engines"][key]["stats"]
        kind = key[0]
        if kind == "Interleave":
            S, V, M_ = key[1:]
            T = ((M_ - 1) % S) + S * V * ((M_ - 1) // S) + 2 * S * V
        else:
            S, V, M_ = 4, 1, key[1]
            T = 2 * M_ + 2 * S - 3 if kind == "1F1B" else M_ + S - 1
        assert st["fwd_slots"] == st["bwd_slots"] == M_ * V
        assert st["permutes"] == 2 * T
        if kind == "1F1B":
            assert st["max_inflight"] == min(S - r, M_)
        if kind == "FThenB":
            assert st["max_inflight"] == M_


@pytest.mark.parametrize("kind", ["gpt", "gpt_untied", "llama"])
def test_lm_pipeline_matches_the_reference(runs, kind):
    """GPT (tied through fleet.distributed_model and the hybrid clip;
    untied with a plain clip) and Llama through pipeline_descs at pp 2:
    copy_weights gives the reference's PipelineLayer state_dict, one
    train_batch its loss and every state_dict() entry on both ranks."""
    ref = runs["ref"]["lm"][kind]
    for res in runs["port"][2]:
        got = res[kind]
        assert sorted(got["copied"]) == sorted(ref["copied"])
        for k, w in ref["copied"].items():
            np.testing.assert_array_equal(got["copied"][k], w, err_msg=k)
        _close(got["losses"][0], ref["loss"], rtol=LOSS_RTOL, atol=0)
        assert sorted(got["state"]) == sorted(ref["state"])
        for k, w in ref["state"].items():
            _close(got["state"][k], w, msg=k)
        assert got["reverse_max_dev"] == 0.0
        assert got["devices"] == ["cpu"]
    assert runs["port"][2][0]["gpt"]["wrapper"] == "PipelineParallel"
    assert runs["port"][2][0]["gpt"]["clip"] == "HybridParallelClipGrad"
    assert runs["port"][2][0]["gpt_untied"]["clip"] == \
        "ClipGradByGlobalNorm"


@pytest.mark.parametrize("kind", ["gpt", "gpt_untied", "llama"])
def test_clip_counts_the_tied_ends_once(runs, kind):
    """The global square-sum under pp (the fused AdamW's, the clip's and
    nn/clip.grad_square_sum's) is the whole model's: each stage's part
    summed over the pp group, the tied embedding (and the ln_f beside it)
    counted once, as the reference's norm over its whole gradient."""
    want = runs["ref"]["lm"][kind]["square_sum"]
    for res in runs["port"][2]:
        for name, got in res[kind]["square_sums"].items():
            _close(got, want, rtol=1e-5, atol=0, msg=name)
    assert "hybrid" in runs["port"][2][0]["gpt"]["square_sums"]


@pytest.mark.parametrize("schedule", ["1F1B", "FThenB"])
def test_block_model_train_batch(runs, schedule):
    """The reference test's block model at pp 4 (weights from its
    PipelineLayer's state_dict through load_jax_state_dict): one
    train_batch with the 1F1B engine, and with F-then-B, against the
    reference's PipelineParallel on build_mesh(dp=2, pp=4)."""
    ref = runs["ref"]["block"]
    for res in runs["port"][4]:
        got = res[("block", schedule)]
        _close(got["losses"][0], ref["loss"], rtol=LOSS_RTOL, atol=0)
        for k, w in ref["state"].items():
            _close(got["state"][k], w, msg=k)


def test_tied_embedding_interleave_train_batch(runs):
    """SharedLayerDesc embedding and tied head at S 4, V 2: ONE layer
    instance, the interleave engine, the reference's loss and state."""
    ref = runs["ref"]["tied"]
    for res in runs["port"][4]:
        assert res["one_instance"] and res["tied_schedule"] == "Interleave"
        _close(res["tied"]["losses"][0], ref["loss"], rtol=LOSS_RTOL,
               atol=0)
        assert sorted(res["tied"]["state"]) == sorted(ref["state"])
        for k, w in ref["state"].items():
            _close(res["tied"]["state"][k], w, msg=k)


def test_refusals(runs):
    """Heterogeneous stages, a virtual_pp_degree mismatch, a stage count
    other than pp, and pp beside a sep axis of two ranks raise, each naming
    its cause (pp beside sep names its ROADMAP item by title)."""
    errs = runs["port"][2][0]["errors"]
    assert errs["heterogeneous"].startswith("ValueError") and \
        "identical stages" in errs["heterogeneous"]
    assert "virtual_pp_degree=2" in errs["vpp_mismatch"]
    assert "4 stages but the mesh 'pp' axis has 2" in errs["stage_count"]
    for res in runs["port"][4]:
        assert res["beside_sep"].startswith("NotImplementedError") and \
            "'sep'" in res["beside_sep"] and \
            "ROADMAP queue 1: pp beside sep, sharding or ep" in \
            res["beside_sep"]


def _replicas_equal(ranks, key, peers, entries):
    """Each rank's own state_dict entries `entries(res)` bitwise equal to
    those of every rank that `peers` maps to the same group."""
    groups = {}
    for r in ranks:
        groups.setdefault(peers(r[key]["coord"]), []).append(r)
    for members in groups.values():
        first = members[0]
        for other in members[1:]:
            for k in entries(first[key]):
                np.testing.assert_array_equal(
                    other[key]["local"][k], first[key]["local"][k],
                    err_msg=k)


@pytest.mark.parametrize("kind", ["block", "gpt"])
def test_dp_pp_train_batch(runs, kind):
    """dp 2 x pp 2: the block model (two blocks a stage, 1F1B) and the tied
    GPT through fleet.distributed_model and the hybrid clip, each rank on
    its rows of the global batch: the reference's loss and state on every
    rank, and the dp replicas bitwise equal."""
    ref = runs["ref"]["block"] if kind == "block" \
        else runs["ref"]["lm"]["gpt"]
    ranks = runs["port"][4]
    for res in ranks:
        got = res[("dp_pp", kind)]
        _close(got["losses"][0], ref["loss"], rtol=LOSS_RTOL, atol=0)
        assert sorted(got["state"]) == sorted(ref["state"])
        for k, w in ref["state"].items():
            _close(got["state"][k], w, msg=k)
        if kind == "gpt":
            assert got["wrapper"] == "PipelineParallel"
            assert got["clip"] == "HybridParallelClipGrad"
            assert got["reverse_max_dev"] == 0.0
    assert {r[("dp_pp", kind)]["coord"]["dp"] for r in ranks} == {0, 1}
    _replicas_equal(ranks, ("dp_pp", kind),
                    lambda c: (c["pp"], c["mp"]),
                    lambda res: res["local"])


@pytest.mark.parametrize("kind", LM_KINDS)
def test_pp_mp_train_batch(runs, kind):
    """pp 2 x mp 2: GPT (its embedding whole, the untied head's columns
    cut) and Llama (its embedding a vocabulary cut; the tied head's logits
    a block of the vocabulary, its loss ParallelCrossEntropy's) through
    pipeline_descs. copy_weights carries the reference's weights (a
    whole Llama's blocks into the cut layers; a cut GPT's embedding
    gathered into the whole pipe embedding), and back; the clip's
    square-sum is the whole model's; one train_batch gives the
    reference's loss and every gathered state_dict() entry; each mp
    pair's whole entries are bitwise equal."""
    ref = runs["ref"]["lm"][kind]
    ranks = runs["port"][4]
    for res in ranks:
        got = res[("pp_mp", kind)]
        assert sorted(got["copied"]) == sorted(ref["copied"])
        for k, w in ref["copied"].items():
            np.testing.assert_array_equal(got["copied"][k], w, err_msg=k)
        for name, sq in got["square_sums"].items():
            _close(sq, ref["square_sum"], rtol=1e-5, atol=0, msg=name)
        _close(got["losses"][0], ref["loss"], rtol=LOSS_RTOL, atol=0)
        assert sorted(got["state"]) == sorted(ref["state"])
        for k, w in ref["state"].items():
            _close(got["state"][k], w, msg=k)
        assert got["reverse_max_dev"] == 0.0
        assert got["whole_model"] == kind.startswith("llama")
        assert got["cut"], "no parameter is cut over the mp group"
    key = ("pp_mp", kind)
    assert {r[key]["coord"]["mp"] for r in ranks} == {0, 1}
    _replicas_equal(ranks, key, lambda c: (c["dp"], c["pp"]),
                    lambda res: [k for k in res["local"]
                                 if k not in res["cut"]])


def test_rotary_gpt_is_refused():
    cfg = GPTConfig(**dict(GPT, use_rotary=True))
    with pytest.raises(ValueError, match="rotary"):
        GPTForCausalLM(cfg, device="cpu").pipeline_descs()
    with _Mesh(None):
        paddle.seed(0)
        jm = JaxGPT(JaxGPTConfig(**dict(GPT, use_rotary=True)))
        with pytest.raises(ValueError, match="rotary"):
            jm.pipeline_descs()


def test_seg_method_layer_bounds():
    """seg_method='layer:<Class>' starts a stage at every k-th layer of the
    class (tests/test_pipeline.py:425-454); the layers run end to end."""
    from paddle_tpu_torch.distributed.fleet import ColumnParallelLinear

    class Marker(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = ColumnParallelLinear(4, 4, device="cpu")
            torch.nn.init.normal_(self.fc.weight)

        def forward(self, x):
            return self.fc(x)

    class Plain(torch.nn.Module):
        def forward(self, x):
            return x

    layers = [Marker(), Plain(), Marker(), Plain(), Plain(), Marker(),
              Plain(), Marker()]
    pl = PipelineLayer(layers, num_stages=2, seg_method="layer:Marker")
    assert pl._stage_bounds == [(0, 5), (5, 8)]
    assert [type(m).__name__ for m in pl.get_stage_layers(1)] == \
        ["Marker", "Plain", "Marker"]
    out = pl(torch.ones(2, 4))
    assert tuple(out.shape) == (2, 4)


def test_accumulation_at_pp_one():
    """With no pp axis train_batch is microbatched gradient accumulation:
    the reference's _train_batch_accumulate on the same weights."""
    block_b, _, _ = _batches()
    d = SMALL_SPEC["d"]
    with _Mesh(None):
        paddle.seed(7)
        jpl = JaxPipelineLayer([_JBlock(d) for _ in range(2)],
                               loss_fn=_jmse)
        state = _jax_state(jpl)
        jpp = JaxPipelineParallel(jpl, strategy=_Strat(accumulate_steps=M))
        jopt = JaxAdamW(SMALL_SPEC["lr"], parameters=jpp.parameters(),
                        weight_decay=0.01)
        want = float(jpp.train_batch(
            tuple(paddle.to_tensor(b) for b in block_b), jopt).numpy())
        want_state = _jax_state(jpl)
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.optimizer import AdamW

    pl = PipelineLayer([ranks.Block(d) for _ in range(2)],
                       loss_fn=ranks.mse)
    load_jax_state_dict(pl, state)
    pp = PipelineParallel(pl, strategy=_Strat(accumulate_steps=M),
                          device="cpu")
    opt = AdamW(SMALL_SPEC["lr"], parameters=pp.parameters(),
                weight_decay=0.01)
    got = float(pp.train_batch(tuple(torch.from_numpy(b) for b in block_b),
                               opt))
    _close(got, want, rtol=LOSS_RTOL, atol=0)
    for k, v in pp.state_dict().items():
        _close(v.detach().numpy(), want_state[k], msg=k)


def test_the_slices_modules_import_neither_jax_nor_the_reference():
    """The slice's modules, imported in a fresh process with
    chip_smoke.py and the rank bodies (the pipeline's and the hybrid
    mesh's): nothing of jax or paddle_tpu comes in."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "before = set(sys.modules)\n"
        "import chip_smoke, _torch_pp_ranks, _torch_hybrid_ranks\n"
        "import paddle_tpu_torch.distributed.pipeline\n"
        "import paddle_tpu_torch.distributed.fleet.pipeline_parallel\n"
        "import paddle_tpu_torch.models\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
