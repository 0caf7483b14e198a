"""Continuous-batching scheduler (host-side policy, no device code;
counterpart of paddle_tpu/serving/scheduler.py:56,156).

Requests flow queued -> prefill -> running -> finished, and the engine calls
one Scheduler tick per decode step: admission happens between decode steps,
prefill is chunked and interleaved with decode, and a finished sequence's
blocks and slot are freed immediately.

Admission uses worst-case KV reservation: a request is admitted only when
the blocks for min(prompt + max_new_tokens, max_model_len) fit beside every
admitted request's reservation (blocks already in the prefix cache cost
nothing), so decode never runs out of blocks mid-flight.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from ..observability.registry import counter as _counter, gauge as _gauge

_ADMITTED = _counter("serving_requests_admitted_total",
                     "Requests admitted into the running batch.", always=True)
_FINISHED = _counter("serving_requests_finished_total",
                     "Requests finished (by reason).", labelnames=("reason",),
                     always=True)
_QUEUED = _gauge("serving_queue_depth", "Requests waiting for admission.",
                 always=True)
_RUNNING = _gauge("serving_running_sequences",
                  "Sequences in prefill or decode.", always=True)

_req_counter = itertools.count()


class Request:
    """One generation request and its lifecycle timestamps
    (time.monotonic(); queue time = prefill_start - arrival, TTFT =
    first_token - arrival; reference scheduler.py:56-120).

    `tier` labels the SLO metrics; `trace_ctx` is a distributed trace
    context copied into every span of the request's trace; a
    `prefill_only` request computes, registers and keeps its prompt's KV
    blocks, then finishes with reason "prefill_complete" and no token."""

    def __init__(self, prompt: List[int], max_new_tokens: int = 16,
                 temperature: float = 0.0, eos_token_id: Optional[int] = None,
                 request_id: Optional[str] = None, tier: str = "default",
                 trace_ctx: Optional[dict] = None,
                 prefill_only: bool = False):
        self.request_id = (request_id if request_id is not None
                           else f"req-{next(_req_counter)}")
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.tier = str(tier) if tier else "default"
        self.trace = None             # observability.RequestTrace
        self.trace_ctx = dict(trace_ctx) if trace_ctx else None
        self.prefill_only = bool(prefill_only)
        self.output_tokens: List[int] = []
        self.state = "queued"
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        self.arrival_time = time.monotonic()
        self.prefill_start: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        # engine-owned prefill progress (tokens of prompt already run)
        self.prefill_pos = 0
        self.prefix_matched = 0       # prompt tokens served from the cache
        self._cow_src = None          # shared block forked at admission
        self._ws_caches = None        # contiguous prefill workspace
        self._pending_n = 0           # sampled tokens not yet fetched
        self._reserved_blocks = 0
        # self-speculation state, attached by the engine when spec is on
        # (greedy requests only); kept after finish for telemetry
        self._drafter = None          # speculative.NgramDrafter
        self._spec = None             # speculative.SpecState
        self._done = threading.Event()       # set at finish (HTTP waiters)
        self._progress = threading.Event()   # pulsed per output flush

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def wait_progress(self, timeout: Optional[float] = None) -> bool:
        """Block until more output tokens were flushed (or the request
        finished). Streaming handlers clear and re-wait in a loop."""
        return self._progress.wait(timeout)

    # -- telemetry --------------------------------------------------------
    def queue_seconds(self) -> Optional[float]:
        if self.prefill_start is None:
            return None
        return self.prefill_start - self.arrival_time

    def ttft_seconds(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def decode_tokens_per_s(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = len(self.output_tokens)
        dt = self.finish_time - self.first_token_time
        return (n - 1) / dt if n > 1 and dt > 0 else None

    def telemetry(self) -> dict:
        """The reference's per-request record (scheduler.py:138-153)."""
        t = {
            "request_id": self.request_id,
            "tier": self.tier,
            "state": self.state,
            "finish_reason": self.finish_reason,
            "prompt_tokens": len(self.prompt),
            "prefix_matched_tokens": self.prefix_matched,
            "output_tokens": len(self.output_tokens),
            "queue_s": self.queue_seconds(),
            "ttft_s": self.ttft_seconds(),
            "decode_tok_s": self.decode_tokens_per_s(),
        }
        if self._spec is not None:
            t["spec_proposed"] = self._spec.proposed
            t["spec_accepted"] = self._spec.accepted
            t["spec_acceptance"] = self._spec.acceptance
        return t


class Scheduler:
    """Owns request state transitions + slot/block accounting. The engine
    drives it: admit() between decode steps, next_prefill() for chunked
    prefill work, start_running()/finish() on transitions."""

    def __init__(self, allocator, max_slots: int, max_model_len: int):
        self.allocator = allocator
        self.max_slots = int(max_slots)
        self.max_model_len = int(max_model_len)
        self.waiting: Deque[Request] = deque()
        self.prefilling: List[Request] = []
        self.running: Dict[int, Request] = {}   # slot -> request
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._reserved_blocks = 0

    def submit(self, req: Request) -> None:
        if len(req.prompt) + 1 > self.max_model_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens leaves no room under "
                f"max_model_len={self.max_model_len}")
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        self.waiting.append(req)
        self._publish()

    def admit(self) -> List[Request]:
        """Move waiting requests into prefill while a slot AND a worst-case
        KV reservation fit (FCFS). The whole reservation becomes the block
        table now, its head any cached shared prefix; the engine prefills
        from req.prefill_pos (= matched tokens)."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            total = min(len(req.prompt) + req.max_new_tokens,
                        self.max_model_len)
            if not self.allocator.can_reserve_prefix(req.prompt, total):
                break
            self.waiting.popleft()
            req.slot = self._free_slots.pop()
            _, matched, cow_src, new_blocks = self.allocator.reserve_prefix(
                req.request_id, req.prompt, total)
            req.prefix_matched = matched
            req.prefill_pos = matched
            req._cow_src = cow_src
            req._reserved_blocks = new_blocks
            self._reserved_blocks += new_blocks
            req.state = "prefill"
            req.prefill_start = time.monotonic()
            self.prefilling.append(req)
            admitted.append(req)
            _ADMITTED.inc()
        self._publish()
        return admitted

    def next_prefill(self) -> Optional[Request]:
        """The request that gets this tick's prefill chunk (FCFS)."""
        return self.prefilling[0] if self.prefilling else None

    def start_running(self, req: Request) -> None:
        """Prefill done (first token sampled, prefix scattered to pages)."""
        self.prefilling.remove(req)
        req.state = "running"
        req.first_token_time = time.monotonic()
        self.running[req.slot] = req
        self._publish()

    def finish(self, req: Request, reason: str) -> None:
        """Evict: free blocks + slot immediately, whatever state the request
        was in."""
        if req.state == "queued":
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        elif req.state == "prefill":
            self.prefilling.remove(req)
        elif req.state == "running":
            self.running.pop(req.slot, None)
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None
        if req.request_id in self.allocator.sequences():
            self.allocator.free(req.request_id)
        self._reserved_blocks -= req._reserved_blocks
        req._reserved_blocks = 0
        req._ws_caches = None
        req._cow_src = None
        req.state = "finished"
        req.finish_reason = reason
        req.finish_time = time.monotonic()
        req._done.set()
        req._progress.set()   # wake streaming readers for the final drain
        _FINISHED.inc(reason=reason)
        self._publish()

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    def counts(self) -> dict:
        return {"waiting": len(self.waiting),
                "prefilling": len(self.prefilling),
                "running": len(self.running),
                "free_slots": len(self._free_slots),
                "reserved_blocks": self._reserved_blocks}

    def _publish(self):
        _QUEUED.set(len(self.waiting))
        _RUNNING.set(len(self.prefilling) + len(self.running))
