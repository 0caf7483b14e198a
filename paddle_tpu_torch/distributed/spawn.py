"""paddle.distributed.spawn (counterpart of paddle_tpu/distributed/spawn.py;
reference: python/paddle/distributed/spawn.py:428).

Launches `nprocs` worker processes running func(*args), each with the
reference's rank environment (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM).

Process model, the reference's: plain subprocesses with a pickle handoff,
not multiprocessing's fork (a forked parent's CUDA context and threads
are unsafe in the child) and not its spawn method (whose main-module fixup
re-executes the parent's __main__). `func` must be a module-level function
of an importable module (pickled by reference): the child finds it, and
this package, through PYTHONPATH.

`backend` names the device the children run on, not (as in the reference)
JAX's platform: "cuda" (the default) leaves the cards visible, and a child
that finds none raises before it runs `func`; a child of rank r takes card
r % the card count as its current device. "cpu" hides every card from the
children (CUDA_VISIBLE_DEVICES is emptied), so `func` must ask for the
CPU, as the tests do. PADDLE_SPAWN_BACKEND carries the choice to `func`.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

__all__ = ["spawn", "ProcessContext"]

_BACKENDS = ("cuda", "cpu")


class ProcessContext:
    """The reference's spawn return object: .processes + .join()."""

    def __init__(self, procs, out_paths, tmpdir):
        self.processes = procs
        self._out_paths = out_paths
        self._tmpdir = tmpdir

    def join(self, timeout=None):
        """Wait for every worker (one deadline for all of them); returns
        their results in rank order, or raises naming the first worker
        that failed, timed out (it is killed) or left no result."""
        results = [None] * len(self.processes)
        errors = []
        deadline = None if timeout is None else time.monotonic() + timeout
        for i, p in enumerate(self.processes):
            try:
                left = None if deadline is None else max(
                    deadline - time.monotonic(), 0.01)
                p.wait(left)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                errors.append((i, "timeout"))
                continue
            try:
                with open(self._out_paths[i], "rb") as f:
                    kind, payload = pickle.load(f)
                if kind == "ok":
                    results[i] = payload
                else:
                    errors.append((i, payload))
            except FileNotFoundError:
                errors.append((i, f"no result (exitcode {p.returncode})"))
        self._tmpdir.cleanup()
        if errors:
            rank, msg = errors[0]
            raise RuntimeError(f"spawn worker {rank} failed:\n{msg}")
        return results


def _subprocess_main():  # the child's entry (see spawn below)
    in_path = os.environ["PADDLE_SPAWN_IN"]
    out_path = os.environ["PADDLE_SPAWN_OUT"]
    try:
        if os.environ.get("PADDLE_SPAWN_BACKEND") == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "spawn(backend='cuda'): this worker sees no CUDA "
                    "device; pass backend='cpu' to run on the CPU")
            rank = int(os.environ["PADDLE_TRAINER_ID"])
            torch.cuda.set_device(rank % torch.cuda.device_count())
        with open(in_path, "rb") as f:
            func, args = pickle.load(f)
        out = func(*args)
        payload = ("ok", out)
    except Exception:  # noqa: BLE001 — the traceback must cross the process
        import traceback

        payload = ("err", traceback.format_exc())
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(out_path + ".tmp", out_path)
    if payload[0] == "err":
        sys.exit(1)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False,
          backend="cuda", timeout=None, **options):
    """Run func(*args) in `nprocs` processes (default: PADDLE_TRAINERS_NUM,
    else one a card, or a CPU count for backend="cpu"); returns a
    ProcessContext (join=False) or the list of per-rank return values
    (join=True)."""
    if backend not in _BACKENDS:
        raise ValueError(f"spawn: backend {backend!r}, expected one of "
                         f"{_BACKENDS}")
    if daemon or options:
        import warnings

        warnings.warn("spawn: daemon and extra options are accepted for API "
                      "parity but have no effect on subprocess workers")
    if nprocs < 1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", 0))
    if nprocs < 1:
        if backend == "cuda":
            import torch

            nprocs = torch.cuda.device_count()
        nprocs = nprocs or os.cpu_count() or 1
    tmpdir = tempfile.TemporaryDirectory(prefix="paddle_spawn_")
    procs, out_paths = [], []
    mod_dir = None
    mod_name = getattr(func, "__module__", None)
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None):
        # the child imports func by its dotted module path: one directory
        # up per package level puts the top package's parent on the path
        mod_dir = os.path.dirname(os.path.abspath(mod.__file__))
        for _ in range(mod_name.count(".")):
            mod_dir = os.path.dirname(mod_dir)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for rank in range(nprocs):
        in_path = os.path.join(tmpdir.name, f"in_{rank}.pkl")
        out_path = os.path.join(tmpdir.name, f"out_{rank}.pkl")
        with open(in_path, "wb") as f:
            pickle.dump((func, args), f)
        env = dict(os.environ)
        env["PADDLE_TRAINER_ID"] = str(rank)
        env["PADDLE_TRAINERS_NUM"] = str(nprocs)
        env["PADDLE_SPAWN_BACKEND"] = backend
        env["PADDLE_SPAWN_IN"] = in_path
        env["PADDLE_SPAWN_OUT"] = out_path
        if backend == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        extra = [p for p in (pkg_parent, mod_dir) if p]
        env["PYTHONPATH"] = os.pathsep.join(
            extra + [env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        p = subprocess.Popen(
            [sys.executable, "-c",
             "from paddle_tpu_torch.distributed.spawn import "
             "_subprocess_main; _subprocess_main()"],
            env=env)
        procs.append(p)
        out_paths.append(out_path)
    context = ProcessContext(procs, out_paths, tmpdir)
    if join:
        return context.join(timeout)
    return context
