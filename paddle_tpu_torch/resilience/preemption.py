"""Preemption-aware shutdown (counterpart of
paddle_tpu/resilience/preemption.py).

A scheduler preempts a job with a SIGTERM and a grace window. The
PreemptionHandler latches SIGTERM/SIGINT into a flag the training loop
polls between steps, so the ResilientTrainer has one preemption source to
honour with a final checkpoint and a clean exit. `attach_elastic` makes a
shrinking membership one more such source.
"""
from __future__ import annotations

import signal as _signal
import threading
from typing import Callable, List, Optional, Tuple

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Latches SIGTERM/SIGINT into a flag.

    Usage:
        handler = PreemptionHandler()
        with handler:                       # installs signal handlers
            trainer.run(..., preemption=handler)

    Signal handlers only install from the main thread (CPython rule); from
    other threads install() degrades to manual trigger()-only mode.
    """

    def __init__(self, signals: Tuple[int, ...] = (_signal.SIGTERM,
                                                   _signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev: List[Tuple[int, object]] = []
        self._installed = False
        self.reason: Optional[str] = None
        self.count = 0
        self._callbacks: List[Callable[[str], None]] = []

    # -- flag --------------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def trigger(self, reason: str = "manual"):
        """Latch preemption programmatically (the chaos harness)."""
        self.count += 1
        if not self._event.is_set():
            self.reason = reason
            self._event.set()
            # flight-recorder dump on the FIRST latch only (repeat signals
            # in the grace window must not spam dumps); observability
            # failures must never break the shutdown path
            try:
                from ..observability import flight_recorder as _flight

                _flight.on_preemption(reason)
            except Exception:  # noqa: BLE001
                pass
        for cb in self._callbacks:
            try:
                cb(reason)
            except Exception:  # noqa: BLE001 - callbacks must not kill it
                pass

    def reset(self):
        self._event.clear()
        self.reason = None

    def add_callback(self, cb: Callable[[str], None]):
        self._callbacks.append(cb)

    # -- signals -----------------------------------------------------------
    def _on_signal(self, signum, frame):  # noqa: ARG002
        self.trigger(f"signal:{_signal.Signals(signum).name}")

    def install(self):
        if self._installed:
            return self
        try:
            for sig in self.signals:
                prev = _signal.signal(sig, self._on_signal)
                self._prev.append((sig, prev))
            self._installed = True
        except ValueError:  # not in main thread: trigger()-only mode
            for sig, prev in self._prev:
                _signal.signal(sig, prev)
            self._prev.clear()
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._prev:
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- elastic integration ----------------------------------------------
    def attach_elastic(self, manager, expected_np: int):
        """Watch a membership (anything with `add_watch_callback`): a
        shrink below `expected_np` members latches preemption, so this rank
        checkpoints and exits cleanly rather than hanging in a collective
        with a dead peer. The callback's argument is either the alive map
        of a fleet elastic manager or distributed.elastic's change-info
        dict (whose "members" are counted; the reference counts that
        dict's keys)."""

        def _cb(alive):
            if isinstance(alive, dict) and "members" in alive:
                alive = alive["members"]
            if len(alive) < expected_np and not self.requested:
                self.trigger(f"elastic:{len(alive)}/{expected_np} alive")

        manager.add_watch_callback(_cb)
        return self
