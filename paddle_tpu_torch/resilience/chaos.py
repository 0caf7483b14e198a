"""Fault injection for the resilience subsystem (counterpart of
paddle_tpu/resilience/chaos.py, without the rank helpers).

Production code calls `crash_point("name")` at chosen spots of checkpoint
writes and file commits; tests and chip_smoke.py arm those points with
`inject_crash(...)` to simulate a process dying mid-save. The harness also
poisons training batches with NaNs (to exercise TrainStep's NaN guard),
kills DataLoader worker processes, delivers fake preemption signals, and
faults real processes: SIGKILL, SIGSTOP and SIGCONT of a process replica
(`kill_process`, `hang_process`, `resume_process`), and a store partition
(`StorePartitionProxy`, a byte-level TCP proxy a victim's store client
connects through). The rank helpers (`kill_rank`, `slow_rank`) wait for
the elastic slice.

Standard library only: framework/io.py and forked DataLoader workers
import it.
"""
from __future__ import annotations

import os
import signal as _signal
import threading
from typing import Dict, Iterable, Optional

__all__ = [
    "InjectedCrash", "inject_crash", "crash_point", "clear", "armed",
    "poison_steps", "should_poison", "note_poisoned", "kill_worker",
    "fake_preemption", "sigstop_supported", "kill_process", "hang_process",
    "resume_process", "StorePartitionProxy", "stats", "reset_stats",
    "scope",
]


class InjectedCrash(RuntimeError):
    """Raised at an armed crash point; simulates the process dying there."""

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


_lock = threading.Lock()
_crash_points: Dict[str, dict] = {}   # name -> {"after": int, "mode": str}
_poison_steps: set = set()

stats = {
    "crashes_injected": 0,
    "steps_poisoned": 0,
    "workers_killed": 0,
    "signals_sent": 0,
    "processes_killed": 0,
    "processes_hung": 0,
    "processes_resumed": 0,
    "partitions_started": 0,
}


def reset_stats():
    for k in stats:
        stats[k] = 0


def clear():
    """Disarm every crash point and poison schedule (stats are kept)."""
    with _lock:
        _crash_points.clear()
        _poison_steps.clear()


def armed(point: Optional[str] = None) -> bool:
    with _lock:
        if point is None:
            return bool(_crash_points)
        return point in _crash_points


def inject_crash(point: str, after: int = 0, mode: str = "raise"):
    """Arm `point`: the (after+1)-th hit fires. mode="raise" raises
    InjectedCrash (the write path really stops mid-flight); mode="exit"
    calls os._exit(23), for subprocess tests where not even finally-blocks
    may run."""
    if mode not in ("raise", "exit"):
        raise ValueError(f"unknown crash mode {mode!r}")
    with _lock:
        _crash_points[point] = {"after": int(after), "mode": mode}


def crash_point(name: str):
    """Instrumentation hook called by production code. No-op unless armed."""
    with _lock:
        entry = _crash_points.get(name)
        if entry is None:
            return
        if entry["after"] > 0:
            entry["after"] -= 1
            return
        del _crash_points[name]  # one-shot: the "process" died here once
        mode = entry["mode"]
        stats["crashes_injected"] += 1
    if mode == "exit":  # pragma: no cover - subprocess tests only
        os._exit(23)
    raise InjectedCrash(name)


# -- NaN poisoning ----------------------------------------------------------

def poison_steps(steps: Iterable[int]):
    """Schedule global step indices whose batch gets a NaN planted (the
    ResilientTrainer consults this before each step)."""
    with _lock:
        _poison_steps.update(int(s) for s in steps)


def should_poison(step: int) -> bool:
    with _lock:
        return int(step) in _poison_steps


def note_poisoned(step: int):
    with _lock:
        _poison_steps.discard(int(step))
        stats["steps_poisoned"] += 1


# -- process-level faults ---------------------------------------------------

def kill_worker(pool, wid: int = 0, sig: int = _signal.SIGKILL):
    """Hard-kill one DataLoader worker process (io/worker.py WorkerPool)."""
    proc = pool.procs[wid]
    os.kill(proc.pid, sig)
    stats["workers_killed"] += 1


def fake_preemption(sig: int = _signal.SIGTERM):
    """Deliver a real signal to this process: exercises the installed
    PreemptionHandler as a scheduler's SIGTERM would."""
    stats["signals_sent"] += 1
    os.kill(os.getpid(), sig)


def _pid_of(proc_or_pid) -> int:
    return int(getattr(proc_or_pid, "pid", proc_or_pid))


def sigstop_supported() -> bool:
    """Can this platform freeze a process (SIGSTOP/SIGCONT)?"""
    return (os.name == "posix" and hasattr(_signal, "SIGSTOP")
            and hasattr(_signal, "SIGCONT"))


def kill_process(proc_or_pid):
    """SIGKILL a real OS process (a process replica): no cleanup handler
    runs, its heartbeats simply stop."""
    os.kill(_pid_of(proc_or_pid), _signal.SIGKILL)
    stats["processes_killed"] += 1


def hang_process(proc_or_pid):
    """SIGSTOP a real OS process: alive by waitpid (no exit code) but
    silent, so only its lease's expiry can declare it dead. Pair with
    resume_process() to wake the zombie and exercise its fence."""
    if not sigstop_supported():
        raise RuntimeError("SIGSTOP/SIGCONT not supported on this platform")
    os.kill(_pid_of(proc_or_pid), _signal.SIGSTOP)
    stats["processes_hung"] += 1


def resume_process(proc_or_pid):
    """SIGCONT a hung process: a superseded process replica must then
    fence itself out (serving/fleet_proc.py) rather than serve."""
    if not sigstop_supported():
        raise RuntimeError("SIGSTOP/SIGCONT not supported on this platform")
    os.kill(_pid_of(proc_or_pid), _signal.SIGCONT)
    stats["processes_resumed"] += 1


class StorePartitionProxy:
    """A network partition for one store client: a TCP forwarding proxy
    the victim's store client connects through, whose traffic can be
    stalled (bytes held, delivered at heal: a switch buffering across a
    link flap) or dropped (every live connection severed) for a window,
    without touching the process itself. Forwarding is byte-level, so it
    works for any store protocol."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 listen_host: str = "127.0.0.1"):
        import socket

        self.upstream = (str(upstream_host), int(upstream_port))
        self._gate = threading.Event()   # set: traffic flows
        self._gate.set()
        self._mode = "stall"
        self._open = True
        self._conns = []                 # live socket pairs, for drop mode
        self._conns_lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((listen_host, 0))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="chaos-partition-accept",
            daemon=True)
        self._accept_thread.start()

    # -- forwarding ---------------------------------------------------------
    def _accept_loop(self):
        import socket

        while self._open:
            try:
                cli, _ = self._srv.accept()
            except OSError:
                return
            if not self._open:
                cli.close()
                return
            try:
                up = socket.create_connection(self.upstream, timeout=10)
                up.settimeout(None)
            except OSError:
                cli.close()
                continue
            with self._conns_lock:
                self._conns.append((cli, up))
            for a, b in ((cli, up), (up, cli)):
                threading.Thread(target=self._pump, args=(a, b),
                                 name="chaos-partition-pump",
                                 daemon=True).start()

    def _pump(self, src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                # the partition gate: while it is down, stall mode holds
                # the bytes here until heal()
                while not self._gate.wait(timeout=0.5):
                    if not self._open:
                        return
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(2)
                except OSError:
                    pass

    # -- chaos controls -----------------------------------------------------
    def partition(self, duration_s: float = 0.0, mode: str = "stall"):
        """Cut the victim's store traffic. mode="stall" holds bytes until
        heal(); mode="drop" severs every live connection (a client with
        one persistent socket sees hard errors). duration_s > 0 arms a
        timer that heals it."""
        if mode not in ("stall", "drop"):
            raise ValueError(f"unknown partition mode {mode!r}")
        self._mode = mode
        stats["partitions_started"] += 1
        self._gate.clear()
        if mode == "drop":
            with self._conns_lock:
                conns, self._conns = self._conns, []
            for cli, up in conns:
                for s in (cli, up):
                    try:
                        s.close()
                    except OSError:
                        pass
        if duration_s > 0:
            t = threading.Timer(float(duration_s), self.heal)
            t.daemon = True
            t.start()

    def heal(self):
        """Restore traffic (a stall's held bytes flow on)."""
        self._gate.set()

    @property
    def partitioned(self) -> bool:
        return not self._gate.is_set()

    def close(self):
        self._open = False
        self._gate.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for cli, up in conns:
            for s in (cli, up):
                try:
                    s.close()
                except OSError:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class scope:
    """Context manager: arm injections inside, guaranteed clear() on exit."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        clear()
        return False
