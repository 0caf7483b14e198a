"""Pipeline parallelism beside data and tensor parallelism in the port
(distributed/fleet/pipeline_parallel.py under fleet's hybrid configs):
eight gloo rank processes at dp 2 x pp 2 x mp 2, the mesh of the
reference's tests/test_completion.py:104, held against the reference's
PipelineParallel.train_batch on the conftest's 8-device CPU mesh at the
same mesh (build_mesh(dp=2, pp=2, mp=2)).

The ranks (tests/_torch_hybrid_ranks.py) train a tiny GPT (tied ends)
and a tiny Llama (untied head) through pipeline_descs,
fleet.distributed_model and the hybrid optimizer: three train_batch
steps on three global batches, each rank on its dp rows, with a
global-norm clip that binds (0.05, AdamW at epsilon 1 so the update
follows the clipped gradient's scale). A child process computes the
reference meanwhile (`_child_refs`).

Tolerances (fp32), those of tests/test_torch_pipeline.py: every loss
1e-5 relative; every state_dict() entry, gathered over mp, 1e-4 relative
+ 1e-6 absolute. Exact: the dp replicas' own state_dict entries after
every step, and each mp pair's whole (replicated) entries.

Every collective of the ranks runs under PADDLE_PG_TIMEOUT (60 s): the
pp handoffs, the mp all-reduces inside the stages and the dp reduce
interleave in each process, and gloo waits on a group whose members
issue their collectives in different orders; with the timeout such a
fault fails this test where it would otherwise hang.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import _torch_hybrid_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.fleet.pipeline_parallel import (
    PipelineLayer as JaxPipelineLayer, PipelineParallel as JaxPipelineParallel)
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.distributed import spawn

LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
SPEC = dict(lr=0.5, eps=1.0, clip=0.05, M=4)
GPT = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=32, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0, tie_word_embeddings=True)
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_key_value_heads=2, intermediate_size=128,
             max_position_embeddings=32, tie_word_embeddings=False)
KINDS = {"gpt": ("gpt", GPT), "llama": ("llama", LLAMA)}
# the rank whose found-inf flag alone is raised: dp 1, pp 0, mp 1
INF_RANK = 5


class _Strat:
    def __init__(self, **cfg):
        self.pipeline_configs = cfg


class _Mesh:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.before = jdist.get_mesh()
        jdist.set_mesh(self.mesh)

    def __exit__(self, *exc):
        jdist.set_mesh(self.before)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _jlm(family, seed=3):
    paddle.seed(seed)
    cfg = KINDS[family][1]
    if family == "llama":
        return JaxLlama(JaxLlamaConfig(**cfg))
    return JaxGPT(JaxGPTConfig(**cfg))


def _batches():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 128, (8, 16)).astype(np.int64) for _ in range(3)]


def _ref(family, batches):
    """The reference's PipelineParallel over the LM's pipeline_descs at
    dp 2 x pp 2 x mp 2: each train_batch's loss, and the final state."""
    with _Mesh(jdist.build_mesh(dp=2, pp=2, mp=2)):
        descs, loss_fn, copy_weights = _jlm(family).pipeline_descs()
        pl = JaxPipelineLayer(descs, num_stages=2, loss_fn=loss_fn)
        copy_weights(pl)
        pp = JaxPipelineParallel(pl, strategy=_Strat(
            accumulate_steps=SPEC["M"]))
        opt = JaxAdamW(SPEC["lr"], epsilon=SPEC["eps"],
                       parameters=pp.parameters(), weight_decay=0.01,
                       grad_clip=JaxClip(SPEC["clip"]))
        losses = []
        for b in batches:
            ids = paddle.to_tensor(b.astype(np.int32))
            losses.append(float(pp.train_batch((ids, ids), opt).numpy()))
        return {"losses": losses, "state": _state(pp)}


def _child_refs(family, path):
    """One LM's reference, written to `path` as a pickle: run in a child
    process of its own (`_start_child`), the two LMs' side by side while
    the ranks run."""
    fast = paddle.get_flags(["jit_fast_dispatch"])
    paddle.set_flags({"jit_fast_dispatch": True})
    try:
        out = _ref(family, _batches())
    finally:
        paddle.set_flags(fast)
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _start_child(family, path):
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [%r, %r]; import conftest; "
            "import test_torch_hybrid_parallel as t; t._child_refs(%r, %r)"
            % (here, os.path.dirname(here), family, path))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid")
    batches = _batches()
    with _Mesh(None):
        lms = {name: (family, dict(cfg), _state(_jlm(family)))
               for name, (family, cfg) in KINDS.items()}
    children = {f: _start_child(f, str(tmp / f"{f}.pkl")) for f in KINDS}
    before = os.environ.get("PADDLE_PG_TIMEOUT")
    os.environ["PADDLE_PG_TIMEOUT"] = "60"
    try:
        ctx = spawn(ranks.world8, args=(lms, batches, SPEC, INF_RANK),
                    nprocs=8, backend="cpu", join=False)
    finally:
        if before is None:
            del os.environ["PADDLE_PG_TIMEOUT"]
        else:
            os.environ["PADDLE_PG_TIMEOUT"] = before
    ref = {}
    try:
        for f, child in children.items():
            _, err = child.communicate(timeout=300)
            if child.returncode:
                raise RuntimeError(f"the reference child ({f}) failed:\n"
                                   f"{err.decode()[-4000:]}")
            with open(tmp / f"{f}.pkl", "rb") as fh:
                ref[f] = pickle.load(fh)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
    return {"ref": ref, "port": ctx.join(300)}


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def test_hybrid_groups(runs):
    """HybridCommunicateGroup's getters on every rank: its dp, pp and mp
    groups are the lines of the grid (dp outermost, mp innermost) through
    its coordinate, and its ranks along them that coordinate."""
    for rank, res in enumerate(runs["port"]):
        c = res["coord"]
        assert rank == 4 * c["dp"] + 2 * c["pp"] + c["mp"]
        assert res["groups"]["dp"] == [2 * c["pp"] + c["mp"],
                                       4 + 2 * c["pp"] + c["mp"]]
        assert res["groups"]["pp"] == [4 * c["dp"] + c["mp"],
                                       4 * c["dp"] + 2 + c["mp"]]
        assert res["groups"]["mp"] == [4 * c["dp"] + 2 * c["pp"],
                                       4 * c["dp"] + 2 * c["pp"] + 1]
        assert res["ranks"] == [c["dp"], c["pp"], c["mp"]]


@pytest.mark.parametrize("name", list(KINDS))
def test_train_batch_matches_the_reference(runs, name):
    """Three train_batch steps with a binding clip: every rank's losses
    and the gathered final state against the reference's at the same
    mesh; the wrapper fleet.distributed_model returns is the
    PipelineParallel (no DataParallel around it), its clip the hybrid
    one, and its step's parts carry the dp reduce."""
    ref = runs["ref"][KINDS[name][0]]
    for res in runs["port"]:
        got = res[name]
        for g, w in zip(got["losses"], ref["losses"]):
            _close(g, w, rtol=LOSS_RTOL, atol=0)
        assert sorted(got["state"]) == sorted(ref["state"])
        for k, w in ref["state"].items():
            _close(got["state"][k], w, msg=k)
        assert got["wrapper"] == "PipelineParallel"
        assert got["clip"] == "HybridParallelClipGrad"
        assert "dp_reduce_s" in got["parts"]
        assert got["cut"]


@pytest.mark.parametrize("name", list(KINDS))
def test_replicas_bitwise_equal(runs, name):
    """After every step: the two dp replicas of a (pp, mp) position hold
    the same bits in every state_dict entry, and the two ranks of an mp
    pair the same bits in every entry that is not cut over mp."""
    port = runs["port"]
    by = {(r["coord"]["dp"], r["coord"]["pp"], r["coord"]["mp"]): r
          for r in port}
    cut = set(port[0][name]["cut"])
    for step in range(len(port[0][name]["local"])):
        for (dp, pp, mp), r in by.items():
            mine = r[name]["local"][step]
            if dp == 1:
                twin = by[(0, pp, mp)][name]["local"][step]
                for k in mine:
                    np.testing.assert_array_equal(mine[k], twin[k],
                                                  err_msg=f"dp {k}")
            if mp == 1:
                twin = by[(dp, pp, 0)][name]["local"][step]
                for k in mine:
                    if k not in cut:
                        np.testing.assert_array_equal(
                            mine[k], twin[k], err_msg=f"mp {k}")


@pytest.mark.parametrize("name", list(KINDS))
def test_found_inf_skips_on_every_rank(runs, name):
    """Under an enabled GradScaler whose found-inf flag one rank alone
    raises (dp 1, pp 0, mp 1), every rank skips the step: its parameters
    keep their bits and its loss scale halves alike."""
    for res in runs["port"]:
        assert res[name]["skip"] == {"unchanged": True, "scale": 512.0}


def test_pg_timeout_reads_the_environment(monkeypatch):
    """PADDLE_PG_TIMEOUT (seconds) is the timeout init_parallel_env and
    every group made after it give gloo; unset, the backend's own."""
    import datetime

    from paddle_tpu_torch.distributed.env import pg_timeout

    monkeypatch.delenv("PADDLE_PG_TIMEOUT", raising=False)
    assert pg_timeout() is None
    monkeypatch.setenv("PADDLE_PG_TIMEOUT", "60")
    assert pg_timeout() == datetime.timedelta(seconds=60)
