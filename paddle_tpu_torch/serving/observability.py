"""Engine counters and the engine's observability hooks.

EngineStats is the counterpart of paddle_tpu/serving/observability.py's
registry-backed per-engine event counters. ServingObservability keeps the
reference engine's hook call sites (submit, admission, prefill chunks, first
token, decode and speculative verify, rollback, finish, ticks) behind one
object whose methods do nothing yet: request traces, SLO histograms, anomaly detectors and the flight
recorder fill them in with the observability slice.
"""
from __future__ import annotations

import itertools
import time

from ..observability.registry import counter as _counter

_ENGINE_EVENTS = _counter(
    "serving_engine_events_total",
    "Serving engine events (prefill dispatches, batched prefills, prefill "
    "tokens, copy-on-write admissions, dedups, speculation ticks), per "
    "engine instance.",
    labelnames=("engine", "event"))
PREFILL_TOKENS = _counter("serving_prefill_tokens_total",
                          "Prompt tokens actually computed by prefill "
                          "(cache hits skip theirs).")
_ENGINE_SEQ = itertools.count()


def new_engine_id() -> str:
    return f"engine{next(_ENGINE_SEQ)}"


class EngineStats:
    """Dict-shaped view over serving_engine_events_total{engine=...}."""

    _KEYS = ("prefill_programs", "batched_prefills", "prefill_tokens",
             "cow_admissions", "dedup_admissions", "spec_ticks",
             "spec_proposed", "spec_accepted", "spec_rollbacks")

    __slots__ = ("_eid",)

    def __init__(self, engine_id: str):
        self._eid = str(engine_id)

    def inc(self, key: str, amount: int = 1) -> None:
        if key not in self._KEYS:
            raise KeyError(key)
        _ENGINE_EVENTS.inc(amount, engine=self._eid, event=key)

    def __getitem__(self, key: str) -> int:
        if key not in self._KEYS:
            raise KeyError(key)
        return int(_ENGINE_EVENTS.value(engine=self._eid, event=key))


class ServingObservability:
    """The engine's lifecycle hooks; no-ops until the observability slice."""

    def __init__(self, engine):
        self.engine = engine

    @staticmethod
    def now() -> float:
        return time.monotonic()

    def tick_begin(self) -> float:
        return self.now()

    def on_submit(self, req) -> None:
        pass

    def on_shed(self, req, reason: str) -> None:
        pass

    def on_admitted(self, req) -> None:
        pass

    def on_prefill_chunk(self, req, t0: float, tokens: int,
                         batched: bool = False) -> None:
        pass

    def on_first_token(self, req) -> None:
        pass

    def on_decode(self, t0: float, running, steps: int,
                  kind: str = "decode", **args) -> None:
        """One decode or speculative-verify call over the batch (kind
        "spec_verify", with its `window` in args)."""

    def on_rollback(self, req, n: int) -> None:
        """A verify window rejected the last n drafted tokens of req."""

    def on_finish(self, req, reason: str) -> None:
        pass

    def on_tick(self, t0: float, out: dict) -> None:
        pass
