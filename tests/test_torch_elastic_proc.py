"""Elastic ranks as processes of their own, on the CPU.

distributed.spawn (a pickle handoff to plain subprocesses with the rank
environment; `backend` the children's device), then chip_smoke.py's
elastic_parity phase run on the CPU in a child of its own with a time
limit: two ElasticTrainer ranks (GPTConfig.tiny(), fp32) and a joiner
started by spawn(backend="cpu") over a native.TCPStore, the joiner's grow
reform, a SIGKILL of rank 1 and the survivors' shrink reform, held to
faultbench's gate-4 checks against a clean two-thread world (loss within
5e-3, survivors' parameters bitwise equal, at most save_every steps
replayed); then ResilientTrainer(cluster=) in two processes, where rank 0
must flag the rank that sleeps in its loss.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.distributed import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _square_plus_rank(x):
    return x * x + int(os.environ["PADDLE_TRAINER_ID"])


def _fail():
    raise ValueError("boom")


def _env():
    return [os.environ[k] for k in ("PADDLE_TRAINER_ID",
                                    "PADDLE_TRAINERS_NUM",
                                    "PADDLE_SPAWN_BACKEND",
                                    "CUDA_VISIBLE_DEVICES")]


def test_spawn_runs_every_rank_and_returns_in_rank_order():
    assert spawn(_square_plus_rank, args=(3,), nprocs=3, backend="cpu",
                 timeout=120) == [9, 10, 11]
    assert spawn(_env, nprocs=2, backend="cpu", timeout=120) == \
        [["0", "2", "cpu", ""], ["1", "2", "cpu", ""]]
    with pytest.raises(ValueError, match="backend"):
        spawn(_env, nprocs=1, backend="tpu")


def test_spawn_names_the_failing_rank_with_its_traceback():
    with pytest.raises(RuntimeError,
                       match=r"(?s)spawn worker 0 failed.*ValueError: boom"):
        spawn(_fail, nprocs=1, backend="cpu", timeout=120)
    ctx = spawn(_fail, nprocs=1, backend="cpu", join=False)
    assert ctx.processes[0].wait(120) == 1


def test_a_cuda_rank_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the rank would run")
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        spawn(_env, nprocs=1, backend="cuda", timeout=120)


def test_elastic_ranks_as_processes_join_and_survive_a_sigkill():
    code = ("import json, torch, chip_smoke as cs; print('ROW ' + "
            "json.dumps(cs.elastic_parity_phase(torch, device='cpu')))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("ROW ")]
    row = json.loads(line[4:])
    assert all(row["gates"].values()), row
    assert [f["members"] for f in row["reforms"]] == [[0, 1, 2], [0, 2]]
    assert row["loss_continuity_dev"] <= row["loss_continuity_tol"]
    assert row["cluster"]["straggler_events"] == [[1, "compute", 3]]
    assert "1" in row["cluster"]["dump_flagged"]


def test_the_slices_modules_import_neither_jax_nor_the_reference():
    """Every module of the port is walked and imported in a fresh process,
    with chip_smoke.py; the slice's modules are among them and nothing of
    jax or paddle_tpu comes in."""
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
    for mod in ("distributed.elastic", "distributed.checkpoint",
                "distributed.spawn", "resilience.elastic",
                "observability.cluster", "native"):
        assert "paddle_tpu_torch." + mod in seen, mod
