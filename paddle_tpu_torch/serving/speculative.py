"""Draft-model-free self-speculation for the serving engine (counterpart of
paddle_tpu/serving/speculative.py, ported line for line).

Two small host-side pieces (no device code here):

``NgramDrafter`` — prompt-lookup drafting: find the longest recent n-gram
in the request's OWN token history (prompt + everything emitted) that
matches the current suffix, and propose the tokens that followed its
previous occurrence. The index is incremental — each gram length keeps a
dict of gram-tuple -> position-after-last-occurrence, extended from a
watermark as history grows (history only grows: drafts never enter it
until verified) — so a propose() call is O(new_tokens * n_lengths), not
O(history).

``SpecState`` — per-request adaptive-k throttle. Acceptance feedback
shrinks/grows the draft length between 1 and the configured cap, and a
run of consecutive fruitless ticks (no match, or zero accepted) pauses
drafting entirely for a fixed number of ticks before probing again, so
non-repetitive traffic degrades to the plain one-token decode path
instead of paying verify-window dispatches that never accept.

The engine consumes these in its speculative tick (engine._spec_step):
draft -> ONE batched verify call over the k+1-token window ->
longest-accepted-prefix commit -> exact rollback of the rejected tail
(BlockAllocator.rollback + device length rewind).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..observability.registry import counter as _counter

# process-wide speculation counters (always on, like every serving_*
# metric of the port's registry): SpecState.record is the single choke
# point every verify tick passes through, so the global accounting lives
# here rather than being re-derived in the engine
_SPEC_PROPOSED = _counter("serving_spec_proposed_total",
                          "Draft tokens offered to speculative "
                          "verification.", always=True)
_SPEC_ACCEPTED = _counter("serving_spec_accepted_total",
                          "Draft tokens accepted by speculative "
                          "verification.", always=True)
_SPEC_ROLLBACKS = _counter("serving_spec_rollbacks_total",
                           "Speculative ticks that rejected >= 1 draft "
                           "token (exact KV rollback).", always=True)


class NgramDrafter:
    """Incremental n-gram lookup over one request's token history.

    Grams of length ``min_n``..``max_n`` are indexed by the position just
    AFTER their occurrence; lookups try the longest suffix first. The
    current suffix itself is never indexed (endings stop one short of the
    history length), so a match always points at a strictly earlier
    occurrence.
    """

    def __init__(self, max_n: int = 3, min_n: int = 2):
        if min_n < 1:
            raise ValueError("min_n must be >= 1")
        self.min_n = int(min_n)
        self.max_n = max(int(max_n), self.min_n)
        self._index: Dict[int, Dict[Tuple[int, ...], int]] = {
            n: {} for n in range(self.min_n, self.max_n + 1)}
        self._upto = 0  # gram endings < _upto are already indexed

    def propose(self, toks: Sequence[int], k: int) -> List[int]:
        """Draft up to k tokens continuing ``toks`` (may return fewer, or
        none when no suffix recurs). ``toks`` must extend the history seen
        by earlier calls — the drafter is per-request state."""
        T = len(toks)
        if k <= 0 or T <= self.min_n:
            return []
        for end in range(max(self._upto, self.min_n), T):
            for n in range(self.min_n, min(self.max_n, end) + 1):
                self._index[n][tuple(toks[end - n:end])] = end
        self._upto = max(self._upto, T)
        for n in range(min(self.max_n, T - 1), self.min_n - 1, -1):
            p = self._index[n].get(tuple(toks[T - n:]))
            if p is not None:
                # the match says history repeats with period T - p from p;
                # extrapolate cyclically so a draft is never truncated just
                # because the latest occurrence sits close to the end
                # (constant or short-cycle tails would otherwise cap the
                # draft at the period instead of k)
                period = T - p
                return [toks[p + (i % period)] for i in range(k)]
        return []


class SpecState:
    """Adaptive draft-length throttle + per-request speculation counters.

    ``draft_k(tick)`` is the length the engine should draft this tick
    (0 = paused). ``record(proposed, accepted, tick)`` feeds acceptance
    back: full/high acceptance grows k toward the cap, a rejected window
    halves it (a no-match tick leaves k alone — it carries no evidence
    about draft quality), and ``miss_limit`` consecutive fruitless ticks
    pause drafting for ``pause_ticks`` engine ticks. After the pause, ONE
    fruitless probe re-pauses immediately with the pause doubled (capped
    at 8x), so a non-repetitive request converges to near-zero
    speculation overhead; decent acceptance (>= 1/4 of the window)
    resets the backoff, while a chance low-acceptance window on
    otherwise-random text leaves it armed.
    """

    def __init__(self, k_max: int, pause_ticks: int = 32,
                 miss_limit: int = 4):
        self.k_max = max(1, int(k_max))
        self.k = self.k_max
        self.pause_ticks = int(pause_ticks)
        self.miss_limit = max(1, int(miss_limit))
        self.proposed = 0          # lifetime draft tokens offered
        self.accepted = 0          # lifetime draft tokens verified
        self.rollbacks = 0         # ticks that rejected >= 1 draft token
        self._miss = 0
        self._resume_tick = 0
        self._pause = self.pause_ticks    # current backoff value

    def draft_k(self, tick: int) -> int:
        return 0 if tick < self._resume_tick else self.k

    def record(self, proposed: int, accepted: int, tick: int) -> None:
        self.proposed += proposed
        self.accepted += accepted
        if proposed:
            _SPEC_PROPOSED.inc(proposed)
        if accepted:
            _SPEC_ACCEPTED.inc(accepted)
        if proposed and accepted < proposed:
            self.rollbacks += 1
            _SPEC_ROLLBACKS.inc()
        if accepted == 0:
            self._miss += 1
            if proposed:
                # a dispatched-and-rejected window is real evidence
                # against the draft source; a mere no-match tick is not
                self.k = max(1, self.k // 2)
            if self._miss >= self.miss_limit:
                self._resume_tick = tick + self._pause
                # exponential backoff: each fruitless probe doubles the
                # next pause (capped), and re-pauses after ONE miss — a
                # non-repetitive request converges to ~zero spec overhead
                self._pause = min(self._pause * 2, 8 * self.pause_ticks)
                self._miss = self.miss_limit - 1
        else:
            if accepted * 4 >= proposed:
                self._miss = 0
                self._pause = self.pause_ticks
            # a LOW-acceptance window (< 1/4 of the draft) leaves the
            # backoff armed: random text throws up chance n-gram repeats
            # whose windows accept a token or two, and letting each lucky
            # hit re-enable miss_limit fresh probes keeps adversarial
            # traffic paying verify dispatches forever
            if accepted * 2 >= proposed:
                self.k = min(self.k_max, self.k + 1)
            else:
                self.k = max(1, self.k - 1)

    @property
    def acceptance(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0
