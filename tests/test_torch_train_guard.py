"""TrainStep's NaN guard, step telemetry and LR schedulers in the port
against the JAX reference, on the CPU.

The 15 LR schedulers (the same lr sequence and state_dict); TrainStep
stepping a scheduler; `TrainStep(nan_guard=True)` on a tiny GPT under amp
O2 with a poisoned step (the same skip verdicts as the reference's, and
the port's parameters, masters, moments and beta powers bitwise unchanged
across it); `TrainStep(telemetry=True)` under FLAGS_metrics, its step
records key by key against the reference's, the flight dump on a NaN skip,
`on_exception`, and the span ring (`span`, `session`, `mark`, `since`).
Each comparison states its tolerance.
"""
import glob
import json
import math
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu import observability as jobs
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
import paddle_tpu_torch.optimizer.lr as tlr

LR = 1e-3
SEQ = 128
POISON = 2          # the step whose loss is multiplied by NaN


# ---------------------------------------------------------- LR schedulers
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 10, learning_rate=1.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 20, 30],
                                                 [1.0, 0.5, 0.1, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 20, end_lr=0.01,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.5, 20, end_lr=0.01, power=2.0, cycle=True),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [10, 25, 40], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, 7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=20, eta_min=0.01),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, T_max=30), 10, 0.0, 0.5),
    "LinearWarmup_float": lambda m: m.LinearWarmup(0.5, 10, 0.05, 0.5),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.5, factor=0.5, patience=2, cooldown=1),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=40),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.5, 5, step_size_down=7,
                                     mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(0.01, 0.5, 5,
                                               mode="exp_range", gamma=0.97),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.97),
}
# ReduceOnPlateau's metric: falls, then stalls (reductions), then falls
METRICS = [1.0 / (1 + i) if i < 15 or i > 35 else 0.07 for i in range(50)]


def _advance(sched, i):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        sched.step(METRICS[i])
    else:
        sched.step()
    return sched()


def test_the_fifteen_schedulers_are_ported():
    names = {n for n, c in vars(jlr).items() if isinstance(c, type)
             and issubclass(c, jlr.LRScheduler)}
    assert len(names) == 16                     # the base and 15
    for n in names:
        assert issubclass(getattr(tlr, n), tlr.LRScheduler), n
    assert {f(tlr).__class__.__name__ for f in SCHEDULERS.values()} == \
        names - {"LRScheduler"}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_the_reference(name):
    """50 steps: the same lr after every step (exactly: the same host
    arithmetic on the same floats) and the same state_dict; a state_dict
    taken at step 25 and loaded into a fresh port scheduler continues the
    same sequence. The reference's own load loses LinearWarmup's inner
    scheduler (the base update puts the inner state dict in its place) and
    ReduceOnPlateau's reduced lr (kept in a private field): the port's
    loads keep both, and the test pins the reference's fault."""
    make = SCHEDULERS[name]
    js, ts = make(jlr), make(tlr)
    assert ts() == js()
    for i in range(25):
        assert _advance(ts, i) == _advance(js, i), i
    assert ts.state_dict() == js.state_dict()
    sd = ts.state_dict()
    fresh = make(tlr)
    fresh.set_state_dict(json.loads(json.dumps(sd)))
    jfresh = make(jlr)
    jfresh.set_state_dict(json.loads(json.dumps(js.state_dict())))
    ref_faulty = name in ("LinearWarmup", "ReduceOnPlateau")
    jfresh_ok = True
    for i in range(25, 50):
        want = _advance(js, i)
        assert _advance(ts, i) == want, i
        assert _advance(fresh, i) == want, i
        if jfresh_ok:
            try:
                jfresh_ok = _advance(jfresh, i) == want
            except AttributeError:
                jfresh_ok = False
    assert jfresh_ok != ref_faulty
    assert ts.state_dict() == js.state_dict()


def test_optimizer_reads_and_sets_the_lr():
    p = torch.nn.Parameter(torch.zeros(3))
    sched = tlr.StepDecay(0.1, 2)
    opt = AdamW(sched, parameters=[p])
    assert opt.get_lr() == 0.1 and opt._lr_scheduler is sched
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.5)
    opt2 = AdamW(0.1, parameters=[p])
    opt2.set_lr(0.25)
    assert opt2.get_lr() == 0.25 and opt2._lr_scheduler is None


# ------------------------------------------------------------- the guard
@pytest.fixture(scope="module")
def gpt_state():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _pair(state, o2):
    """The reference and the port: the same weights, AdamW (global-norm
    clip at 1.0) over LinearWarmup(CosineAnnealingDecay), decorated for O2
    when asked; loss_fn(ids, poison) multiplies the loss by the 0-d
    `poison` (1 or NaN)."""
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(tm, state)

    def sched(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(LR, T_max=20), 2,
                              LR / 10, LR)

    jopt = JaxAdamW(sched(jlr), parameters=jm.parameters(),
                    weight_decay=0.01, grad_clip=JaxClip(1.0))
    topt = AdamW(sched(tlr), parameters=tm.parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))
    level = "O2" if o2 else "O1"
    if o2:
        jm, jopt = paddle.amp.decorate(jm, jopt, level="O2")
        tm, topt = amp.decorate(tm, topt, level="O2")

    def jloss(x, poison):
        with paddle.amp.auto_cast(enable=o2, level=level):
            return jm(x, labels=x) * poison

    def tloss(x, poison):
        with amp.auto_cast(enable=o2, level=level):
            return tm(x, labels=x) * poison

    return jm, tm, jopt, topt, jloss, tloss


def _batches(n=4):
    ids = np.random.default_rng(1).integers(
        0, GPTConfig.tiny().vocab_size, (2, SEQ)).astype(np.int32)
    return [(ids, np.float32(np.nan if i == POISON else 1.0))
            for i in range(n)]


def _run_reference(jstep, batches):
    paddle.set_flags({"pallas_interpret": True})
    try:
        out = []
        for ids, poison in batches:
            loss = float(jstep(paddle.to_tensor(ids),
                               paddle.to_tensor(poison)).numpy())
            out.append((loss, jstep.last_skipped, jstep.skipped_steps))
        return out
    finally:
        paddle.set_flags({"pallas_interpret": False})


def _snapshot(opt):
    """Every flat buffer and every parameter's beta powers, copied."""
    bufs = [t.clone() for g in opt._groups
            for t in (g.p, g.master, g.m, g.v) if t is not None]
    pows = [(s["beta1_pow"], s["beta2_pow"]) for s in opt._state.values()]
    return bufs, pows


def test_nan_guard_skips_a_poisoned_step_as_the_reference(gpt_state):
    """Four O2 steps, the third poisoned: the port's skip verdicts and
    counts equal the reference's after every step; across the poisoned
    step the port's bf16 parameters, fp32 masters, moments and beta powers
    are bitwise unchanged (the kernel's skip flag stored nothing) while the
    scheduler and the step count still advance, as the reference's do;
    clean losses agree to 1e-3 relative (the O2 bound) and the poisoned
    one is NaN in both."""
    jm, tm, jopt, topt, jloss, tloss = _pair(gpt_state, o2=True)
    batches = _batches()
    want = _run_reference(JaxTrainStep(jm, jloss, jopt, nan_guard=True),
                          batches)
    tstep = TrainStep(tm, tloss, topt, device="cpu", nan_guard=True)
    for i, (ids, poison) in enumerate(batches):
        if i == POISON:
            before = _snapshot(topt)
            lr_before = topt.get_lr()
        loss = float(tstep(ids.astype(np.int64), poison))
        if i == POISON:
            after = _snapshot(topt)
            for a, b in zip(before[0], after[0]):
                assert torch.equal(a, b)
            assert before[1] == after[1]
            assert topt.get_lr() != lr_before
        got = (loss, tstep.last_skipped, tstep.skipped_steps)
        assert got[1:] == want[i][1:], i
        if i == POISON:
            assert math.isnan(loss) and math.isnan(want[i][0])
        else:
            assert loss == pytest.approx(want[i][0], rel=1e-3)
    assert tstep.skipped_steps == 1 and not tstep.last_skipped
    assert topt._step_count == jopt._step_count == len(batches)
    assert topt.get_lr() == jopt.get_lr()
    assert topt._lr_scheduler.last_epoch == jopt._lr_scheduler.last_epoch


# ------------------------------------------------------------- telemetry
@pytest.fixture
def metrics_dirs(tmp_path):
    """FLAGS_metrics on in both packages, each writing to its own dir."""
    dirs = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    jobs.reset_all()
    tobs.reset_all()
    paddle.set_flags({"metrics": "on", "metrics_dir": dirs["ref"]})
    tflags.set_flags({"metrics": "on", "metrics_dir": dirs["port"]})
    yield dirs
    paddle.set_flags({"metrics": "off", "metrics_dir": ""})
    tflags.set_flags({"metrics": "off", "metrics_dir": ""})
    jobs.reset_all()
    tobs.reset_all()


def _records(d):
    with open(os.path.join(d, "events.jsonl")) as f:
        return [r for r in (json.loads(x) for x in f) if r["kind"] == "step"]


def _dumps(d):
    return [json.load(open(p))
            for p in sorted(glob.glob(os.path.join(d, "flight", "*.json")))]


def test_telemetry_records_match_the_reference(gpt_state, metrics_dirs):
    """Four fp32 steps with telemetry (FLAGS_metrics on) and the guard, the
    third poisoned, a data phase before the second and a save phase after
    it. Record by record: the same keys (less the reference's autotune and
    compile_cache, whose modules are not ported, and mfu, which the port
    computes only on a card whose peak it knows), step, skipped, samples,
    tokens, flops = 6 n_params tokens and lr exactly, the loss to 1e-5 and
    the pre-clip gradient norm to 1e-4 relative (fp32; NaN in both on the
    poisoned step), the phases' keys, and the merged data and save
    times. One flight dump each, reason nan_guard, with the same payload
    keys, the skipped step in its ring and the train-step spans; the
    registry's mirrors count 4 steps and 1 skip."""
    jm, tm, jopt, topt, jloss, tloss = _pair(gpt_state, o2=False)
    batches = _batches()
    jstep = JaxTrainStep(jm, jloss, jopt, nan_guard=True)
    tstep = TrainStep(tm, tloss, topt, device="cpu", nan_guard=True)
    assert tstep._telemetry                     # follows FLAGS_metrics
    cores = {"ref": [], "port": []}
    for name, tele in (("ref", jobs.telemetry.get_telemetry()),
                       ("port", tobs.telemetry.get_telemetry())):
        def on_step(core, _orig=tele.on_step, _seen=cores[name]):
            _seen.append(dict(core))
            return _orig(core)
        tele.on_step = on_step
    paddle.set_flags({"pallas_interpret": True})
    try:
        for i, (ids, poison) in enumerate(batches):
            if i == 1:
                jobs.telemetry.get_telemetry().pre_phase("data", 0.5)
                tobs.telemetry.get_telemetry().pre_phase("data", 0.5)
            jstep(paddle.to_tensor(ids), paddle.to_tensor(poison))
            tstep(ids.astype(np.int64), poison)
            if i == 1:
                jobs.telemetry.get_telemetry().post_phase("save", 0.25)
                tobs.telemetry.get_telemetry().post_phase("save", 0.25)
    finally:
        paddle.set_flags({"pallas_interpret": False})
    assert tobs.telemetry.get_telemetry().last_record()["step"] == 3
    jobs.telemetry.get_telemetry().finalize()
    tobs.telemetry.get_telemetry().finalize()
    want, got = _records(metrics_dirs["ref"]), _records(metrics_dirs["port"])
    assert len(got) == len(want) == len(batches)
    n_params = sum(p.numel() for p in tm.parameters())
    for w, g in zip(want, got):
        assert set(g) == set(w) - {"autotune", "compile_cache", "mfu"}
        for k in ("step", "skipped", "samples", "tokens", "lr",
                  "reduce_overlapped"):
            assert g[k] == w[k], k
        assert set(g["phases"]) == set(w["phases"])
        for k in ("data", "save", "reduce"):
            assert g["phases"][k] == w["phases"][k], k
        if g["skipped"]:
            assert math.isnan(g["loss"]) and math.isnan(w["loss"])
            assert math.isnan(g["grad_norm"]) and math.isnan(w["grad_norm"])
        else:
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    # what TrainStep handed telemetry: the reference's core, less its
    # autotune, compile_cache and reduce_overlapped entries
    for w, g in zip(cores["ref"], cores["port"]):
        assert set(g) == set(w) - {"autotune", "compile_cache",
                                   "reduce_overlapped"}
        assert g["flops"] == w["flops"] == 6.0 * n_params * 2 * SEQ
    assert [g["skipped"] for g in got] == [i == POISON
                                           for i in range(len(batches))]
    assert got[1]["phases"]["data"] == 0.5 and got[1]["phases"]["save"] == 0.25
    (jd,), (td,) = _dumps(metrics_dirs["ref"]), _dumps(metrics_dirs["port"])
    assert td["reason"] == jd["reason"] == "nan_guard"
    assert set(td) == set(jd)
    assert [s["step"] for s in td["steps"] if s["skipped"]] == [POISON]
    assert any(e["kind"] == "nan_skip" and e["step"] == POISON
               for e in td["events"])
    assert sum(s["name"] == "jit.train_step" for s in td["spans"]) == \
        POISON + 1
    reg = tobs.registry.default_registry()
    assert reg.get("training_steps_total").value() == 4
    assert reg.get("training_steps_skipped_total").value() == 1
    summ = tobs.telemetry.get_telemetry().summary()
    assert summ["records"] == 4 and set(summ["phase_ms_avg"]) == \
        set(tobs.telemetry.PHASES)


def test_on_exception_dumps_like_the_reference(metrics_dirs):
    """on_exception: a dump with reason "exception", the exception's type,
    message and traceback, and the same payload keys as the reference's;
    nothing while FLAGS_metrics is off."""
    paths = {}
    for name, fr in (("ref", jobs.flight_recorder),
                     ("port", tobs.flight_recorder)):
        try:
            raise ValueError("boom")
        except ValueError as e:
            paths[name] = fr.on_exception(e)
    jd, td = (json.load(open(paths[k])) for k in ("ref", "port"))
    assert td["reason"] == jd["reason"] == "exception"
    assert set(td) == set(jd)
    assert td["exception"]["type"] == "ValueError"
    assert td["exception"]["message"] == "boom"
    assert "raise ValueError" in td["exception"]["traceback"]
    tflags.set_flags({"metrics": "off"})
    assert tobs.flight_recorder.on_exception(ValueError("x")) is None
    assert tobs.flight_recorder.on_nan_skip(3) is None


def test_spans_record_as_the_reference():
    """span() records only while FLAGS_metrics is on or a session is open,
    in both packages alike; mark()/since() return what came after the
    mark; spans carry their category and arguments."""
    jobs.reset_all()
    tobs.reset_all()
    try:
        seen = {}
        for name, sp in (("ref", jobs.spans), ("port", tobs.spans)):
            with sp.span("off"):
                pass
            sp.session(True)
            mark = sp.mark()
            with sp.span("in_session", cat="jit", args={"k": 1}):
                pass
            sp.session(False)
            with sp.span("closed"):
                pass
            seen[name] = ([s["name"] for s in sp.tail(10)],
                          [(s["name"], s["cat"], s.get("args"))
                           for s in sp.since(mark)])
        assert seen["port"] == seen["ref"] == (
            ["in_session"], [("in_session", "jit", {"k": 1})])
    finally:
        jobs.reset_all()
        tobs.reset_all()
