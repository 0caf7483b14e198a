"""ZeRO in the port (distributed/sharding.py: group_sharded_parallel at
"os", "os_g" and "p_g_os", zero_state_sharding and zero_grad_sharding,
save_group_sharded_model; AdamW over a shard; TrainStep's ZeRO path; the
sharded square-sum of the clip) and the rest of distributed/checkpoint.py
(save_sharded, wait_all, CheckpointSaveError, save_model_sharded,
load_model_sharded) with resilience.CheckpointManager(backend="orbax"),
over gloo rank processes, held against the reference on the conftest's
8-device CPU mesh and against the port at world 1.

Two rank worlds run while this process computes the reference (their
bodies are in tests/_torch_zero_ranks.py): world 2 (sharding 2, through
fleet.init) and world 4 (dp 2 x sharding 2). Every rank gets the same
global batches and the reference's weights.

Tolerances (fp32 unless stated):
  * each stage at world 2, its clip binding, against the reference's
    TrainStep under group_sharded_parallel on build_mesh(sharding=2) on
    the same weights and global batches: losses 1e-5 relative (the
    reference's own test), parameters and moments 1e-5 absolute plus 1e-5
    relative (two half-batch gradients averaged, the square-sum over two
    shards, against one whole-batch program);
  * without a clip, the three stages and TrainStep(dp_axis="dp") at
    world 2: bitwise, losses, parameters and moments (a sum of two values
    has one rounding in any order);
  * dp 2 x sharding 2 at "os_g" against the port's world-1 TrainStep:
    the bounds of the first case;
  * the master form under amp O2 at "os_g" against the port's world-1 O2
    step: losses 2e-3 relative (a bf16 loss's half-ulp is 2e-3 of it);
    every master within 2 lr a step of the world-1 masters and, over the
    model, within 0.02 lr on average (bf16 gradients of a half batch
    summed in bf16: an element's Adam update may change by up to 2 lr
    where its gradient is rounding noise, as the key bias's is); without
    a clip, bitwise the O2 TrainStep(dp_axis="dp") at world 2;
  * the square-sum at "os": the shards' within 1e-6 relative of the
    averaged whole gradient's, the clip factor too;
  * between-step bytes a rank within 3% of 12 N, 10 N and 8 N fp32
    words' bytes (4 bytes x 3 N, 2.5 N and 2 N: the padding of each unit
    to 2 x 64 elements is the excess);
  * the checkpoints: bitwise.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_zero_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.resilience.checkpoint_manager import \
    CheckpointManager as JaxCheckpointManager
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.sharding import ALIGN
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.convert import (gather_state_dict,
                                             load_jax_state_dict)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.checkpoint_manager import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, O2_LR, CLIP = 1e-4, 1e-3, 0.05
ATOL = RTOL = 1e-5
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=32, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0)


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


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _jmodel(state=None):
    paddle.seed(11)
    m = JaxGPT(JaxGPTConfig(**CFG))
    if state is not None:
        m.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return m


def _ref_stage(level, state, batches):
    """The reference's TrainStep under group_sharded_parallel at `level`
    on build_mesh(sharding=2): losses, parameters and the optimizer's
    moments by the port's names (param_i, i the parameter's position)."""
    before = jdist.get_mesh()
    jdist.set_mesh(jdist.build_mesh(sharding=2))
    try:
        model = _jmodel(state)
        opt = JaxAdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                       grad_clip=JaxClip(CLIP))
        model, opt, _ = jdist.group_sharded_parallel(model, opt, level)
        step = JaxTrainStep(model, lambda x: model(x, labels=x), opt)
        losses = [float(step(paddle.to_tensor(b.astype(np.int32))).numpy())
                  for b in batches]
        moments = {}     # the step's own state (step.params' order)
        for i, st in enumerate(step.opt_state):
            for slot in ("moment1", "moment2"):
                moments[f"param_{i}.{slot}"] = np.array(st[slot],
                                                        dtype=np.float32)
        params = {k: np.array(_np(v)) for k, v in model.state_dict().items()}
        return {"losses": losses, "params": params, "opt": moments}
    finally:
        jdist.set_mesh(before)


def _port_world1(state, batches, lr, clip, o2=False):
    """The port's TrainStep at world 1 on the whole batches."""
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state_dict(model, state)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    if o2:
        model, opt = amp.decorate(model, opt, level="O2")

    def loss_fn(x):
        with amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            return model(x, labels=x)

    step = TrainStep(model, loss_fn, opt, device="cpu")
    losses = [float(step(b)) for b in batches]
    out = {"losses": losses, "params": gather_state_dict(model)}
    if o2:
        out["masters"] = {
            n: opt.state_dict()["master_weights"][f"param_{i}"].numpy()
            for i, (n, _) in enumerate(model.named_parameters())}
    return out


def _ref_checkpoint(path, ref):
    """The reference's rank-sharded write (its write_rank_shard at world 2,
    both shards, then the index) of a state in save_model_sharded's
    keys: the reference's trained parameters and moments."""
    state = {"model": ref["params"], "optimizer": dict(ref["opt"])}
    index = None
    for r in range(2):
        index = jck.write_rank_shard(path, r, 2, state, "ref-nonce")
    jck.write_shard_index(path, index)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero")
    with _NoMesh():
        state = {k: np.asarray(v.numpy())
                 for k, v in _jmodel().state_dict().items()}
    batches = _batches()
    fast = paddle.get_flags(["jit_fast_dispatch"])
    paddle.set_flags({"jit_fast_dispatch": True})
    ref_ckpt = str(root / "ref_written")
    ctxs = {2: spawn(ranks.zero_world,
                     args=(CFG, state, batches, LR, CLIP, str(root / "port"),
                           ref_ckpt, O2_LR),
                     nprocs=2, backend="cpu", join=False),
            4: spawn(ranks.dp_sharding_world,
                     args=(CFG, state, batches, LR, CLIP),
                     nprocs=4, backend="cpu", join=False)}
    try:
        ref = {}
        for level in ("os", "os_g", "p_g_os"):
            ref[level] = _ref_stage(level, state, batches)
            if level == "os":   # the world-2 ranks wait for it
                _ref_checkpoint(ref_ckpt, ref["os"])
    finally:
        paddle.set_flags(fast)
    world1 = {"fp32": _port_world1(state, batches, LR, CLIP),
              "o2": _port_world1(state, batches, O2_LR, CLIP, o2=True)}
    port = {n: ctx.join(300) for n, ctx in ctxs.items()}
    return {"root": root, "state": state, "ref": ref, "world1": world1,
            "port": port}


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=msg)


def _same_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_each_stage_matches_the_reference_group_sharded_step(runs, level):
    """Three steps at world 2 through fleet's hybrid optimizer, its clip
    binding: losses, the gathered parameters and the whole moments against
    the reference's group-sharded TrainStep; both ranks alike."""
    ref = runs["ref"][level]
    res = [r[("clip", level)] for r in runs["port"][2]]
    assert res[0]["clip"] == "HybridParallelClipGrad"
    for r in res:
        _close(r["losses"], ref["losses"], atol=0)
        for k, want in ref["params"].items():
            _close(r["params"][k], want, msg=k)
        for k, want in ref["opt"].items():
            _close(r["opt"][k], want, msg=k)
    _same_dicts(res[0]["params"], res[1]["params"])


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_stages_are_bitwise_the_data_parallel_step(runs, level):
    """No clip: each stage's losses, parameters and moments equal
    TrainStep(dp_axis="dp")'s at world 2 bit for bit."""
    for r in runs["port"][2]:
        got, want = r[("plain", level)], r["dp"]
        assert got["losses"] == want["losses"]
        _same_dicts(got["params"], want["params"])
        _same_dicts(got["opt"], want["opt"])


def _units_hold(got, want, n_units):
    """Stage 3 of a small model bit for bit the data-parallel step, in
    `n_units` units, a step's live gathered bytes at most the two largest
    units' (one unit's forward, the next one's backward)."""
    assert got["losses"] == want["losses"]
    _same_dicts(got["params"], want["params"])
    assert len(got["unit_bytes"]) == n_units
    top2 = sum(sorted(got["unit_bytes"])[-2:])
    assert all(0 < p <= top2 for p in got["peaks"]), \
        (got["peaks"], got["unit_bytes"])


def test_stage3_units_of_a_model_that_is_not_gpt(runs):
    """At "p_g_os" a model that declares no units has one for each child,
    a ModuleList's children in its place, and one for its own parameters:
    an MLP (two linear layers in a ModuleList and a scale of its own) bit
    for bit the data-parallel step, in 3 units."""
    for r in runs["port"][2]:
        _units_hold(r["mlp"], r["mlp_dp"], 3)


@pytest.mark.parametrize("kind", ["gpt_model", "llama"])
def test_stage3_units_a_model_declares(runs, kind):
    """GPTModel on its own (its blocks in a ModuleList) and a tiny Llama
    (its layers inside LlamaModel) declare their units: the embeddings,
    each block and the final norm (with Llama's head), 4 at 2 layers; bit
    for bit the data-parallel step."""
    for r in runs["port"][2]:
        _units_hold(r[kind], r[f"{kind}_dp"], 4)


def test_dp_by_sharding_matches_world_one(runs):
    """World 4, dp 2 x sharding 2 at "os_g": the groups fleet builds, and
    three clipped steps against the port's world-1 TrainStep."""
    res = runs["port"][4]
    want = runs["world1"]["fp32"]
    assert [r["dp_group"] for r in res] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["sharding_group"] for r in res] == [[0, 1], [0, 1], [2, 3],
                                                  [2, 3]]
    for r in res:
        _close(r["losses"], want["losses"], atol=0)
        for k, w in want["params"].items():
            _close(r["params"][k], w, msg=k)
    for r in res[1:]:
        _same_dicts(r["params"], res[0]["params"])


def test_master_form_at_os_g_matches_world_one_o2(runs):
    """amp O2 at "os_g": bf16 parameters, fp32 masters in the shard, the
    master form over it; three steps against the port's world-1 O2
    step (bounds in the module note)."""
    want = runs["world1"]["o2"]
    for r in runs["port"][2]:
        got = r["o2"]
        _close(got["losses"], want["losses"], atol=0, rtol=2e-3)
        steps = len(want["losses"])
        devs = []
        for i, (name, w) in enumerate(want["masters"].items()):
            dev = np.abs(got["opt"][f"master.param_{i}"] - w)
            assert dev.max() <= 2 * O2_LR * steps, name
            devs.append(dev.ravel())
        assert np.concatenate(devs).mean() <= 0.02 * O2_LR
        # without a clip, bit for bit the O2 data-parallel step
        assert r["o2_plain"]["losses"] == r["o2_dp"]["losses"]
        _same_dicts(r["o2_plain"]["opt"], r["o2_dp"]["opt"])
        _same_dicts(r["o2_plain"]["params"], r["o2_dp"]["params"])


@pytest.mark.parametrize("level,words", [("os", 3.0), ("os_g", 2.5),
                                         ("p_g_os", 2.0)])
def test_bytes_held_between_steps(runs, level, words):
    """What a rank keeps between steps, from its storages: 12 N, 10 N and
    8 N bytes at world 2 (N fp32 parameters), within 3%; what each rank
    owns of every parameter's state (and, past "os", gradient) covers it
    once."""
    for r in runs["port"][2]:
        res = r[("plain", level)]
        want = 4 * words * res["n_params"]
        for held in res["held"]:
            assert want <= held <= 1.03 * want, (held, want)
    owned = [r[("clip", level)] for r in runs["port"][2]]
    sizes = [sum(b - a for a, b in o["owned_state"]) for o in owned]
    assert sum(sizes) == owned[0]["n_params"]
    if level == "os":
        assert all(o["owned_grad"] is None for o in owned)
    else:
        assert [o["owned_grad"] for o in owned] == \
            [o["owned_state"] for o in owned]


def test_square_sum_counts_each_element_once_at_os(runs):
    """At "os" a rank still holds its whole gradient buffer: the clip's
    square-sum is the shards' summed once over the sharding group (the
    reference's hybrid clip would add the whole over the group again)."""
    for r in runs["port"][2]:
        sq = r[("clip", "os")]["square_sum"]
        np.testing.assert_allclose(sq["square_sum"], sq["want"], rtol=1e-6)
        np.testing.assert_allclose(sq["factor"], sq["want_factor"],
                                   rtol=1e-6)
        assert sq["factor"] < 1.0       # the clip binds


def test_stage3_parts_of_the_step(runs):
    """TrainStep.last_parts at "p_g_os": the step's parts, the gathers'
    and the backward's reduce-scatters' seconds and the peak of live
    gathered bytes, at most the embeddings' and one block's (the head
    gathers the embeddings again)."""
    for r in runs["port"][2]:
        parts = r[("clip", "p_g_os")]["parts"]
        assert {"fwd_bwd_s", "reduce_scatter_s", "square_sum_s", "adamw_s",
                "all_gather_s", "gathers_in_fwd_bwd_s",
                "reduce_scatter_in_bwd_s"} <= set(parts)
        h, v, p = CFG["hidden_size"], CFG["vocab_size"], \
            CFG["max_position_embeddings"]
        emb = (v + p) * h
        block = 12 * h * h + 13 * h
        pad = 2 * ALIGN         # a unit's padding is under 2 x ALIGN
        assert parts["gathered_peak_bytes"] <= 4 * (
            emb + block + 2 * pad)
        assert parts["gathered_peak_bytes"] >= 4 * emb


@pytest.mark.parametrize("level", ["os", "p_g_os"])
def test_port_checkpoint_read_by_the_reference(runs, level):
    """save_model_sharded at world 2 ("os"; "p_g_os" through
    save_group_sharded_model with async_save and wait_all): the
    reference's load_sharded gathers it at world 1 and re-slices it at
    world 2, bit for bit the ranks' whole state."""
    path = str(runs["root"] / "port" / level)
    res = runs["port"][2][0][("clip", level)]
    whole = jck.load_sharded(path, target_world_size=1)
    _same_dicts({k: np.asarray(v) for k, v in whole["model"].items()},
                res["params"])
    for k, want in res["opt"].items():
        np.testing.assert_array_equal(np.asarray(whole["optimizer"][k]),
                                      want, err_msg=k)
    for r in range(2):
        part = jck.load_sharded(path, target_world_size=2, target_rank=r)
        for k, want in res["params"].items():
            a, b = tck.split_bounds(want.shape[0], 2)[r]
            np.testing.assert_array_equal(np.asarray(part["model"][k]),
                                          want[a:b], err_msg=k)
    assert not os.path.exists(path + ".saving")


def test_reference_rank_sharded_write_loads_into_zero(runs):
    """The reference's write_rank_shard checkpoint loaded by the port's
    load_model_sharded into an "os_g" model and optimizer at world 2:
    the whole parameters and moments bit for bit."""
    ref = runs["ref"]["os"]
    for r in runs["port"][2]:
        got = r["loaded"]
        _same_dicts(got["params"], ref["params"])
        for k, want in ref["opt"].items():
            np.testing.assert_array_equal(got["opt"][k], want, err_msg=k)


def test_the_refusals(runs, tmp_path):
    """offload, sync_buffers, buffer_max_size, sync_comm, segment_size
    and a dp_group other than the mesh's (the mesh's own is taken); a bad
    level; sharding beside mp and beside sep; no mesh; no such axis;
    declared units that leave parameters out; an Orbax directory in
    load_sharded and in the orbax manager's validation."""
    for r in runs["port"][2]:
        err = r["errors"]
        for key in ("offload", "sync_buffers", "buffer_max_size",
                    "sync_comm", "segment_size", "dp_group"):
            assert err[key].startswith("NotImplementedError") \
                and key in err[key]
        assert err["dp_group_of_the_mesh"] is None
        assert err["units"].startswith("ValueError") \
            and "fc.1.weight" in err["units"] and "scale" in err["units"]
        assert err["level"].startswith("ValueError") and "p_g" in err["level"]
        assert "sharding x mp" in err["mp"]
        assert "sharding x sep" in err["sep"]
        assert err["no_mesh"].startswith("RuntimeError") \
            and "mesh" in err["no_mesh"]
        assert err["no_axis"].startswith("ValueError") and "zz" in \
            err["no_axis"]
    orbax = str(tmp_path / "orbax")
    with _NoMesh():
        jck.save_sharded({"w": paddle.to_tensor(np.ones(4, np.float32))},
                         orbax)
    with pytest.raises(NotImplementedError, match="Orbax") as e:
        tck.load_sharded(orbax)
    assert orbax in str(e.value)
    root = str(tmp_path / "mgr")
    JaxCheckpointManager(root, backend="orbax").save(
        1, {"w": np.ones(3, np.float32)})
    mgr = CheckpointManager(root, backend="orbax")
    assert "Orbax" in mgr.validate(mgr._dir_for(1))
    assert mgr.restore_latest() is None


def test_save_sharded_async_and_wait_all(tmp_path):
    """World 1: a synchronous and an async save_sharded (joined by
    wait_all) read back by both packages' load_sharded; a bf16 leaf and a
    scalar; nothing pending after."""
    path = str(tmp_path / "ck")
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    tck.save_sharded({"w": w, "b": w.bfloat16(), "s": np.float32(3.5)},
                     path)
    tck.save_sharded({"w": w * 2, "n": [np.arange(5)]}, path,
                     async_save=True)
    tck.wait_all()
    assert not tck._pending
    for load in (tck.load_sharded, jck.load_sharded):
        got = load(path)
        np.testing.assert_array_equal(np.asarray(got["w"]), (w * 2).numpy())
        np.testing.assert_array_equal(np.asarray(got["n"][0]), np.arange(5))
    with pytest.raises(FileExistsError):
        tck.save_sharded({"w": w}, path, overwrite=False)


def test_wait_all_joins_every_save_and_aggregates():
    """Two failing pending saves: both are finished and closed, and one
    CheckpointSaveError carries both causes (the reference's case)."""
    class FailPending:
        def __init__(self):
            self.closed = False

        def finish(self):
            raise RuntimeError("async boom")

        def close(self):
            self.closed = True

    a, b = FailPending(), FailPending()
    tck._pending.extend([a, b])
    with pytest.raises(tck.CheckpointSaveError) as ei:
        tck.wait_all()
    assert len(ei.value.errors) == 2
    assert a.closed and b.closed
    assert not tck._pending


@pytest.mark.parametrize("async_save", [False, True])
def test_a_save_that_dies_keeps_the_previous_checkpoint(tmp_path,
                                                        async_save):
    """A save killed while it writes its shard (chaos point `ckpt.shard`)
    raises (at wait_all for an async one) and leaves the last good
    checkpoint in place; the next save clears the debris and commits."""
    path = str(tmp_path / "ck")
    tck.save_sharded({"w": torch.ones(4)}, path)
    chaos.inject_crash("ckpt.shard")
    try:
        if async_save:
            tck.save_sharded({"w": torch.zeros(4)}, path, async_save=True)
            with pytest.raises(tck.CheckpointSaveError) as e:
                tck.wait_all()
            assert isinstance(e.value.errors[0], chaos.InjectedCrash)
        else:
            with pytest.raises(chaos.InjectedCrash):
                tck.save_sharded({"w": torch.zeros(4)}, path)
    finally:
        chaos.clear()
    np.testing.assert_array_equal(tck.load_sharded(path)["w"].numpy(),
                                  np.ones(4, np.float32))
    assert os.path.isdir(path + ".saving")
    tck.save_sharded({"w": torch.full((4,), 2.0)}, path)
    np.testing.assert_array_equal(jck.load_sharded(path)["w"],
                                  np.full(4, 2.0, np.float32))
    assert not os.path.exists(path + ".saving")


def test_checkpoint_manager_orbax_backend_round_trips(tmp_path):
    """CheckpointManager(backend="orbax") saves, validates and restores;
    the manifest names "orbax"; the reference's manager restores the
    port's directory and its payload is the rank-sharded layout."""
    root = str(tmp_path / "mgr")
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "step": np.int64(7)}
    mgr = CheckpointManager(root, backend="orbax")
    mgr.save(3, state, meta={"m": 1})
    assert mgr.validate(mgr._dir_for(3)) is None
    got = mgr.restore_latest()
    assert got.step == 3 and got.meta == {"m": 1}
    np.testing.assert_array_equal(got.state["w"].numpy(),
                                  state["w"].numpy())
    assert tck.is_rank_sharded(os.path.join(mgr._dir_for(3), "arrays"))
    back = JaxCheckpointManager(root, backend="orbax").restore_latest()
    assert back.step == 3
    np.testing.assert_array_equal(np.asarray(back.state["w"]),
                                  state["w"].numpy())


def test_the_slices_modules_import_neither_jax_nor_the_reference():
    """The slice's modules, walked and imported in a fresh process with
    chip_smoke.py: nothing of jax or paddle_tpu comes in."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(n for n in new\n"
        "                      if n.startswith('paddle_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = set(out.stdout.split())
    for mod in ("distributed.sharding", "distributed.sharding_utils",
                "distributed.checkpoint", "optimizer.optimizers",
                "resilience.checkpoint_manager"):
        assert "paddle_tpu_torch." + mod in seen, mod
