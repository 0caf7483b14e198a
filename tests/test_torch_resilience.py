"""The port's resilience runtime against the JAX reference, on the CPU.

paddle_tpu_torch.resilience (RetryPolicy, chaos, CheckpointManager,
ResilientTrainer) and framework.io (save/load), each held to the
reference's own cases (tests/test_resilience.py) and against the
reference's files: a checkpoint the port writes is validated and restored
by the reference's CheckpointManager and the other way round (bf16 leaves
included), a reference paddle.save file loads in the port, and a
checkpoint the reference's ResilientTrainer wrote resumes in the port with
the losses the reference's own continuation gives. Resumed and skipped
runs are held bitwise; the cross-package continuation to the tolerance
stated there.
"""
import os
import shutil
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu.resilience.trainer import ResilientTrainer as JaxTrainer
from paddle_tpu_torch import amp
from paddle_tpu_torch.framework import load, save
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import (CheckpointManager,
                                         PreemptionHandler, RetryError,
                                         RetryPolicy, chaos, retrying)
from paddle_tpu_torch.resilience.trainer import ResilientTrainer


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.clear()
    jax_chaos.clear()
    yield
    chaos.clear()
    jax_chaos.clear()


# ------------------------------------------------------------ retry policy
class TestRetryPolicy:
    def test_retries_then_succeeds(self):
        sleeps = []
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError("refused")
            return "ok"

        pol = RetryPolicy(max_attempts=5, base_delay=0.01,
                          sleep=sleeps.append)
        assert pol.call(flaky) == "ok"
        assert calls["n"] == 3 and len(sleeps) == 2

    def test_gives_up_with_cause(self):
        pol = RetryPolicy(max_attempts=2, base_delay=0.0,
                          sleep=lambda s: None)
        with pytest.raises(RetryError) as ei:
            pol.call(lambda: (_ for _ in ()).throw(OSError("nope")))
        assert ei.value.attempts == 2
        assert isinstance(ei.value.last_exception, OSError)

    def test_filter_passes_through_non_transient(self):
        pol = RetryPolicy(max_attempts=5, retry_on=(OSError,),
                          sleep=lambda s: None)
        with pytest.raises(ValueError):
            pol.call(lambda: (_ for _ in ()).throw(ValueError("fatal")))

    def test_backoff_schedule_and_jitter_bounds(self):
        pol = RetryPolicy(base_delay=0.1, multiplier=2.0, max_delay=0.5,
                          jitter=0.5)
        assert pol.delay_for(1) == pytest.approx(0.1)
        assert pol.delay_for(2) == pytest.approx(0.2)
        assert pol.delay_for(10) == pytest.approx(0.5)  # capped
        for attempt in (1, 2, 3):
            d = pol.delay_for(attempt)
            for _ in range(20):
                j = pol._jittered(d)
                assert d * 0.5 <= j <= d

    def test_deadline_stops_retrying(self):
        pol = RetryPolicy(max_attempts=0, base_delay=10.0, deadline=0.5,
                          sleep=lambda s: None)
        with pytest.raises(RetryError):
            pol.call(lambda: (_ for _ in ()).throw(OSError("x")))

    def test_decorator(self):
        calls = {"n": 0}

        @retrying(max_attempts=3, base_delay=0.0, sleep=lambda s: None)
        def f():
            calls["n"] += 1
            if calls["n"] < 2:
                raise OSError
            return 7

        assert f() == 7

    def test_jitter_sequence_matches_the_reference(self):
        """Same seeded spread: the port's jittered delays are the
        reference's, number for number."""
        from paddle_tpu.resilience import RetryPolicy as JaxPolicy

        mine, ref = RetryPolicy(jitter=0.7), JaxPolicy(jitter=0.7)
        assert [mine.jittered_delay(a) for a in range(1, 9)] == \
            [ref.jittered_delay(a) for a in range(1, 9)]


# ------------------------------------------------- crash-consistent commits
def _w(v, n=4):
    return torch.full((n,), float(v))


class TestCheckpointManager:
    def test_save_restore_roundtrip_with_meta(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        state = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                 "t": torch.arange(5, dtype=torch.int64),
                 "h": torch.randn(3, 4).to(torch.bfloat16),
                 "s": np.float32(0.5),
                 "b": [np.ones(3, np.float32), 7, "tag", None]}
        m.save(1, state, meta={"epoch": 2})
        r = m.restore_latest()
        assert r.step == 1 and r.meta == {"epoch": 2}
        np.testing.assert_array_equal(r.state["a"].numpy(), state["a"])
        assert torch.equal(r.state["t"], state["t"])
        assert r.state["h"].dtype == torch.bfloat16
        assert torch.equal(r.state["h"], state["h"])
        assert r.state["s"].shape == () and float(r.state["s"]) == 0.5
        assert r.state["b"][1:] == [7, "tag", None]

    def test_gc_keeps_last_n_and_tmp_debris_removed(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep_last_n=2)
        for s in (1, 2, 3, 4):
            m.save(s, {"w": _w(1)})
        assert m.all_steps() == [3, 4]
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))

    @pytest.mark.parametrize("asynchronous", [False, True])
    @pytest.mark.parametrize("point", [
        "ckpt.begin", "ckpt.array", "ckpt.before_manifest",
        "ckpt.before_commit",
    ])
    def test_crash_at_every_point_keeps_previous_valid(self, tmp_path, point,
                                                       asynchronous):
        """A crash before the commit rename: the previous checkpoint is
        the latest; under async_save the crash surfaces at wait()."""
        m = CheckpointManager(str(tmp_path), keep_last_n=2,
                              async_save=asynchronous)
        m.save(1, {"w": _w(1)})
        m.wait()
        chaos.inject_crash(point)
        with pytest.raises(chaos.InjectedCrash):
            m.save(2, {"w": _w(2)})
            m.wait()
        r = m.restore_latest()
        assert r.step == 1
        assert torch.equal(r.state["w"], _w(1))
        # the torn write must not block a later healthy save
        m.save(2, {"w": _w(2)})
        assert m.restore_latest().step == 2

    @pytest.mark.parametrize("asynchronous", [False, True])
    def test_crash_after_commit_only_skips_gc(self, tmp_path, asynchronous):
        m = CheckpointManager(str(tmp_path), keep_last_n=1,
                              async_save=asynchronous)
        m.save(1, {"w": _w(1, 2)})
        m.wait()
        chaos.inject_crash("ckpt.before_gc")
        with pytest.raises(chaos.InjectedCrash):
            m.save(2, {"w": _w(0, 2)})
            m.wait()
        assert m.restore_latest().step == 2  # committed before the "crash"
        m.save(3, {"w": _w(1, 2)})  # GC catches up
        m.wait()
        assert m.all_steps() == [3]

    def test_restore_falls_back_on_corruption(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep_last_n=3)
        for s in (1, 2):
            m.save(s, {"w": _w(s)})
        with open(os.path.join(m._dir_for(2), "arr_0.bin"), "r+b") as f:
            f.write(b"\xde\xad\xbe\xef")
        r = m.restore_latest()
        assert r.step == 1
        assert any("checksum mismatch" in reason
                   for _, reason in m.last_scan_report)

    def test_missing_manifest_is_invalid(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(1, {"w": _w(1, 2)})
        os.remove(os.path.join(m._dir_for(1), "manifest.json"))
        assert m.restore_latest() is None

    def test_gc_never_removes_last_valid(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep_last_n=1)
        m.save(1, {"w": _w(1, 2)})
        m.save(2, {"w": _w(0, 2)})
        os.remove(os.path.join(m._dir_for(2), "manifest.json"))
        m._gc()
        assert m.all_steps() == [2]  # nothing provably good: no deletion

    def test_async_save_commits_on_wait_from_a_snapshot(self, tmp_path):
        """The async snapshot is taken before save() returns: later
        in-place writes to the saved tensors (as the next step makes to
        the optimizer's flat buffers, through their views) do not reach
        the checkpoint; the commit lands by wait()."""
        m = CheckpointManager(str(tmp_path), async_save=True)
        flat = torch.arange(10, dtype=torch.float32)
        state = {"a": flat[:4].view(2, 2), "b": flat[4:],
                 "n": np.full(3, 5.0, np.float32)}
        m.save(3, state)
        flat.add_(100.0)
        state["n"][:] = -1.0
        m.wait()
        assert m.all_steps() == [3]
        r = m.restore_latest()
        assert torch.equal(r.state["a"], torch.arange(4.0).view(2, 2))
        assert torch.equal(r.state["b"], torch.arange(4.0, 10.0))
        assert torch.equal(r.state["n"], torch.full((3,), 5.0))

    def test_template_places_and_unported_backends_raise(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(1, {"w": _w(3)})
        r = m.restore_latest(template={"w": torch.zeros(4)})
        assert torch.equal(r.state["w"], _w(3))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            CheckpointManager(str(tmp_path), backend="orbax")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            CheckpointManager(str(tmp_path), world_size=2)


# ----------------------------------------------- one format, both packages
def _bf16_pair(rng, shape):
    """The same bf16 values as a torch tensor and a jax array."""
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def test_port_checkpoint_validates_and_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    tb, jb = _bf16_pair(rng, (3, 5))
    f32 = rng.standard_normal((4, 2)).astype(np.float32)
    state = {"params": [torch.from_numpy(f32), tb],
             "opt_state": [{"beta1_pow": np.asarray(0.9, np.float32),
                            "step": torch.tensor(7)}]}
    CheckpointManager(str(tmp_path)).save(5, state, meta={"epoch": 1})
    ref = JaxManager(str(tmp_path))
    assert ref.validate(ref._dir_for(5)) is None
    r = ref.restore_latest()
    assert r.step == 5 and r.meta == {"epoch": 1}
    np.testing.assert_array_equal(np.asarray(r.state["params"][0]), f32)
    got = r.state["params"][1]
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(jb, np.float32))
    assert float(r.state["opt_state"][0]["beta1_pow"]) == np.float32(0.9)
    assert int(r.state["opt_state"][0]["step"]) == 7


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    tb, jb = _bf16_pair(rng, (6,))
    f32 = rng.standard_normal((2, 3)).astype(np.float32)
    JaxManager(str(tmp_path)).save(
        9, {"w": jnp.asarray(f32), "h": jb, "k": [np.int32(3), "x"]},
        meta={"offset": 4})
    m = CheckpointManager(str(tmp_path))
    assert m.validate(m._dir_for(9)) is None
    r = m.restore_latest()
    assert r.step == 9 and r.meta == {"offset": 4}
    np.testing.assert_array_equal(r.state["w"].numpy(), f32)
    assert r.state["h"].dtype == torch.bfloat16
    assert torch.equal(r.state["h"], tb)
    assert int(r.state["k"][0]) == 3 and r.state["k"][1] == "x"


# --------------------------------------------------------- framework.io
def test_save_load_roundtrip_and_atomic_replace(tmp_path):
    path = str(tmp_path / "m.pdparams")
    p = torch.nn.Parameter(torch.randn(3, 2))
    obj = {"p": p, "h": torch.randn(4).to(torch.bfloat16),
           "i": torch.arange(3), "nested": [torch.ones(2), 5, "s"]}
    save(obj, path)
    got = load(path, device="cpu")
    assert isinstance(got["p"], torch.nn.Parameter) and \
        got["p"].requires_grad
    assert torch.equal(got["p"], p.detach())
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"],
                                                            obj["h"])
    assert torch.equal(got["i"], obj["i"])
    assert got["nested"][1:] == [5, "s"]
    np.testing.assert_array_equal(load(path, return_numpy=True)["h"],
                                  obj["h"].float().numpy())
    # a crash before the replace keeps the old file whole
    chaos.inject_crash("io.save.before_replace")
    with pytest.raises(chaos.InjectedCrash):
        save({"p": torch.zeros(3)}, path)
    assert torch.equal(load(path, device="cpu")["p"], p.detach())
    save({"p": torch.zeros(3)}, path)
    assert torch.equal(load(path, device="cpu")["p"], torch.zeros(3))


def test_load_reads_a_reference_paddle_save_file(tmp_path):
    path = str(tmp_path / "ref.pdparams")
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal(5).astype(np.float32)
    lin = paddle.nn.Linear(4, 2)
    paddle.save({"w": paddle.to_tensor(w),
                 "h": paddle.to_tensor(h).astype("bfloat16"),
                 "layer": lin.state_dict(), "n": 3}, path)
    got = load(path, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), w)
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"], torch.from_numpy(h).to(torch.bfloat16))
    for k, v in lin.state_dict().items():
        np.testing.assert_array_equal(got["layer"][k].detach().numpy(),
                                      np.asarray(v.numpy()))
    assert got["n"] == 3
    np.testing.assert_array_equal(load(path, return_numpy=True)["w"], w)


def test_load_raises_without_a_gpu_unless_asked_for_the_cpu(tmp_path,
                                                             monkeypatch):
    path = str(tmp_path / "x.pd")
    save({"w": torch.ones(2)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(path)
    assert torch.equal(load(path, device="cpu")["w"], torch.ones(2))


# ------------------------------------------------------ resilient training
def _mlp_trainer(root, save_every=4, **kw):
    torch.manual_seed(3)
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                            torch.nn.Linear(8, 1))
    opt = AdamW(0.05, parameters=m.parameters())
    return ResilientTrainer(
        m, lambda a, b: ((m(a) - b) ** 2).mean(), opt,
        CheckpointManager(root), save_every=save_every, device="cpu", **kw)


def _batches(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 4).astype(np.float32),
             rng.randn(8, 1).astype(np.float32)) for _ in range(n)]


def _params(tr):
    return [p.detach().clone() for p in tr.model.parameters()]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


class TestResilientTrainer:
    def test_killed_during_save_resumes_bit_identical(self, tmp_path):
        batches = _batches()
        ref = _mlp_trainer(str(tmp_path / "ref"), save_every=0)
        ref.run(batches, epochs=1)

        root = str(tmp_path / "crash")
        tr = _mlp_trainer(root, save_every=4)
        # the step-4 save lands; the step-8 one dies mid-commit
        chaos.inject_crash("ckpt.before_commit", after=1)
        with pytest.raises(chaos.InjectedCrash):
            tr.run(batches, epochs=1)
        tr2 = _mlp_trainer(root, save_every=4)
        rep = tr2.run(batches, epochs=1)
        assert rep["resumed_from"] == 4
        assert rep["status"] == "completed" and rep["step"] == 10
        assert _equal(_params(tr2), _params(ref))

    def test_nan_guard_skips_exactly_poisoned_steps(self, tmp_path):
        batches = _batches()
        poisoned = _mlp_trainer(str(tmp_path / "a"), save_every=0)
        chaos.poison_steps([3, 7])
        rep = poisoned.run(batches, epochs=1)
        assert rep["steps_skipped"] == 2
        assert poisoned.step.skipped_steps == 2
        # the guard makes a poisoned step an exact no-op: the same batches
        # without them give bitwise the same parameters
        clean = _mlp_trainer(str(tmp_path / "b"), save_every=0)
        rep2 = clean.run([b for i, b in enumerate(batches)
                          if i not in (3, 7)], epochs=1)
        assert rep2["steps_skipped"] == 0
        assert _equal(_params(poisoned), _params(clean))

    def test_preemption_signal_final_save_and_resume(self, tmp_path):
        batches = _batches()
        root = str(tmp_path / "pre")
        tr = _mlp_trainer(root, save_every=0)

        def feed():
            for i, b in enumerate(batches):
                if i == 3:
                    chaos.fake_preemption(signal.SIGTERM)
                yield b

        prev = signal.getsignal(signal.SIGTERM)
        rep = tr.run(feed, epochs=1)
        assert rep["status"] == "preempted"
        assert rep["preempt_reason"] == "signal:SIGTERM"
        assert rep["step"] == 3
        assert signal.getsignal(signal.SIGTERM) == prev
        tr2 = _mlp_trainer(root, save_every=0)
        rep2 = tr2.run(batches, epochs=1)
        assert rep2["status"] == "completed"
        assert rep2["resumed_from"] == 3 and rep2["steps_run"] == 7
        ref = _mlp_trainer(str(tmp_path / "ref"), save_every=0)
        ref.run(batches, epochs=1)
        assert _equal(_params(tr2), _params(ref))

    def test_manual_trigger_and_reset(self):
        h = PreemptionHandler()
        seen = []
        h.add_callback(seen.append)
        h.trigger("manual")
        assert h.requested and h.reason == "manual" and seen == ["manual"]
        h.reset()
        assert not h.requested and h.reason is None

    def test_loss_scale_backoff_shrinks_on_skip(self):
        scaler = amp.GradScaler(init_loss_scaling=1024.0,
                                incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
        backoff = amp.LossScaleBackoff(scaler)
        backoff.on_step(True)
        assert backoff.scale == pytest.approx(512.0)
        backoff.on_step(False)
        backoff.on_step(False)
        assert backoff.scale == pytest.approx(1024.0)
        assert backoff.skipped_steps == 1

    def test_gpt_with_dropout_recompute_and_async_save_resumes_bitwise(
            self, tmp_path):
        """Tiny GPT, hidden dropout 0.1 (its masks from the model's own
        generator, whose state the checkpoint carries), recompute on,
        async saves: killed at the step-4 commit, a fresh trainer from
        other initial weights resumes from step 2 and ends bitwise where
        the uninterrupted run ends, losses included. torch's deterministic
        CPU kernels: the embedding's backward otherwise sums duplicate rows
        across threads in any order."""
        torch.use_deterministic_algorithms(True)
        try:
            self._gpt_resume(tmp_path)
        finally:
            torch.use_deterministic_algorithms(False)

    def _gpt_resume(self, tmp_path):
        cfg = GPTConfig.tiny()
        cfg.num_layers, cfg.hidden_dropout_prob = 1, 0.1
        cfg.recompute = True
        ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (6, 2, 32))
        batches = [(x,) for x in ids]

        def make(root, seed):
            model = GPTForCausalLM(cfg, device="cpu", seed=seed)
            opt = AdamW(1e-3, parameters=model.parameters())
            tr = ResilientTrainer(
                model, lambda x: model(x, labels=x), opt,
                CheckpointManager(root, keep_last_n=2, async_save=True),
                save_every=2, device="cpu")
            losses = []
            _record_losses(tr.step, losses)
            return tr, losses

        ref, ref_losses = make(str(tmp_path / "ref"), 0)
        ref.run(batches)
        tr, _ = make(str(tmp_path / "run"), 0)
        chaos.inject_crash("ckpt.before_commit", after=1)
        with pytest.raises(chaos.InjectedCrash):
            tr.run(batches)
        tr2, losses = make(str(tmp_path / "run"), 7)
        rep = tr2.run(batches)
        assert rep["resumed_from"] == 2 and rep["step"] == 6
        assert losses == ref_losses[2:]
        assert _equal(_params(tr2), _params(ref))
        for p, q in zip(tr2.model.parameters(), ref.model.parameters()):
            a, b = tr2.optimizer._get_state(p), ref.optimizer._get_state(q)
            assert torch.equal(a["moment1"], b["moment1"])
            assert torch.equal(a["moment2"], b["moment2"])
            assert a["beta1_pow"] == b["beta1_pow"]


def _record_losses(step, out):
    """Make a TrainStep (either package's) append each step's loss."""
    base = type(step)

    def call(self, *batch):
        loss = base.__call__(self, *batch)
        val = loss.detach() if torch.is_tensor(loss) else loss.numpy()
        out.append(float(np.asarray(val)))
        return loss

    step.__class__ = type("Recording" + base.__name__, (base,),
                          {"__call__": call})


def test_reference_trainer_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's ResilientTrainer trains a tiny GPT (AdamW, fp32)
    over four batches, saving every two steps, and dies at the step-4
    commit. From the step-2 checkpoint the reference's own fresh trainer
    and the port's (other initial weights) each run steps 3 and 4: the
    port's losses equal the reference's to 1e-5 relative (fp32, the
    tolerance of the TrainStep parity test), and its parameters after them
    agree within 2 lr a step."""
    cfg = JaxGPTConfig.tiny()
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 2, 32)
                                            ).astype(np.int32)
    batches = [(x,) for x in ids]
    root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    lr = 1e-3

    def jax_trainer(seed):
        paddle.seed(seed)
        jm = JaxGPT(cfg)
        opt = JaxAdamW(lr, parameters=jm.parameters(), weight_decay=0.01)
        return JaxTrainer(jm, lambda x: jm(x, labels=x), opt,
                          JaxManager(root), save_every=2), jm

    jtr, _ = jax_trainer(0)
    jax_chaos.inject_crash("ckpt.before_commit", after=1)
    with pytest.raises(jax_chaos.InjectedCrash):
        jtr.run(batches)
    shutil.copytree(root, port_root)

    jtr2, jm2 = jax_trainer(1)
    want = []
    _record_losses(jtr2.step, want)
    rep = jtr2.run(batches)
    assert rep["resumed_from"] == 2 and len(want) == 2

    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu", seed=9)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01)
    tr = ResilientTrainer(model, lambda x: model(x, labels=x), opt,
                          CheckpointManager(port_root), save_every=2,
                          device="cpu")
    got = []
    _record_losses(tr.step, got)
    rep = tr.run([(x.astype(np.int64),) for x in ids])
    assert rep["resumed_from"] == 2 and rep["step"] == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jp = dict(jm2.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[name].numpy()),
                                   atol=2 * lr * 2)


def test_trainer_raises_without_a_gpu_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    m = torch.nn.Linear(2, 1)
    opt = AdamW(0.1, parameters=m.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResilientTrainer(m, lambda a: m(a).sum(), opt, str(tmp_path))
    ResilientTrainer(m, lambda a: m(a).sum(), opt, str(tmp_path),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ResilientTrainer(m, lambda a: m(a).sum(), opt, str(tmp_path),
                         device="cpu", cluster=object())
