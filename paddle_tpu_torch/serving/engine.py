"""ServingEngine: continuous-batching decode over the paged KV pool
(counterpart of paddle_tpu/serving/engine.py:163).

One engine tick (`step()`) = admit -> prefill -> one decode step:

  * decode runs the model over a fixed set of slots: every running
    sequence contributes its last token; the paged decode kernel reads each
    slot's own block table and length. Idle slots point at the null block 0
    with length 0, write their garbage KV there and their outputs are
    ignored. Greedy and per-slot temperature sampling happen on the device.
  * an all-greedy tick runs `fuse_steps` decode steps at once (the
    reference's `_decode_multi_jit`): model, argmax, the token fed back in
    place, lengths advanced, each step's tokens into a static [k, slots]
    output. On a card that body is a CUDA graph, captured at construction
    while every slot is idle and replayed every greedy tick (the
    counterpart of the reference's one compiled dispatch); on the CPU it
    runs eagerly. A tick with a sampled row runs eagerly at k = 1.
  * token fetches are deferred (the reference's `_pending` and
    `_flush_pending`): each tick's tokens stay on the device until a
    value can matter (a request with an eos id, one at its budget or
    context cap, or a speculative tick that drafts), then every pending
    tick comes to the host in one transfer.
  * prefill runs the model's contiguous cached path in a private workspace,
    one bounded chunk per tick per prompt (a burst may prefill up to one
    chunk per idle slot in a tick), then scatters the finished prefix into
    the sequence's pages and joins the decode batch. A partial prefix-cache
    hit gathers the cached blocks into the workspace first; a full-prompt
    hit joins decode directly by copy-on-write of its last block; a burst of
    short greedy prompts prefills in one batched call with per-row offsets.
    A `prefill_only` request keeps its indexed blocks and finishes with
    reason "prefill_complete" (disaggregated prefill); export_kv_blocks and
    ingest_kv_blocks move such blocks between engines.
  * self-speculative decoding (`spec_k > 0`, speculative.py): each greedy
    request drafts up to k tokens by n-gram lookup over its own history;
    one model call scores a fixed window of W = spec_k + 1 tokens a slot
    over the paged pool (the verify kernel); the longest draft prefix that
    matches the greedy targets is kept with the bonus token, and the
    rejected tail is rolled back exactly (allocator rollback and the
    device lengths). Sampled requests ride the window with no draft and
    take one token, drawn from the first column's logits. A tick where
    nobody drafts runs the plain decode step. Excludes fuse_steps > 1.

Decode state (tokens, block tables, lengths, temperatures, live-slot mask)
lives in device tensors written only in place, as are the KV pages, so a
captured graph reads them at every replay; host mirrors keep the
bookkeeping.

The graph's rules: capture while every slot is idle (the warm-up run
executes the body, which then writes only the null page); never rebind a
static tensor (`_d_*`, the pool's pages, the model's weights); a replay
runs no kernel wrapper, so the launch counts' deltas over the capture are
added at every replay (ops/gpu `add_launch_counts`). A capture or replay
that fails raises.
"""
from __future__ import annotations

import random
import threading
from typing import List, Optional

import numpy as np
import torch

from ..core import flags as _flags
from ..core.place import resolve_device
from ..models.generation import init_kv_cache
from ..ops import gpu as _gpu
from .blocks import BlockAllocator
from .observability import (PREFILL_TOKENS, EngineStats, ServingObservability,
                            new_engine_id)
from .paged import PagedKVPool, PagedLayerCache, write_prefix
from .scheduler import Request, Scheduler
from .speculative import NgramDrafter, SpecState

_flags.define_flag("serving_block_size", 16,
                   "KV-cache block size (tokens per page) for the serving "
                   "engine's paged pool.")
_flags.define_flag("serving_slots", 4,
                   "Decode batch slots: max sequences decoding concurrently.")
_flags.define_flag("serving_kv_blocks", 0,
                   "KV pool size in blocks. 0 = auto: enough for every slot "
                   "at max_model_len (no admission ever blocks on KV).")
_flags.define_flag("serving_prefill_chunk", 32,
                   "Prompt tokens prefilled per engine tick (must be a "
                   "multiple of serving_block_size).")
_flags.define_flag("serving_fuse_steps", 1,
                   "Greedy decode steps run per tick as one unit (one CUDA "
                   "graph replay on a card). 1 (default) disables fusion. "
                   "Sampled ticks never fuse; mutually exclusive with "
                   "serving_spec_k > 0.")
_flags.define_flag("serving_max_model_len", 0,
                   "Serving context cap (prompt + generated). 0 = the "
                   "model's max_position_embeddings.")
_flags.define_flag("serving_prefix_cache", True,
                   "Automatic prefix caching: content-address full KV "
                   "blocks so prompts sharing a prefix skip its prefill.")
_flags.define_flag("serving_spec_k", 0,
                   "Self-speculative decoding: max draft tokens verified "
                   "per tick. Drafts are n-gram / prompt-lookup matches "
                   "from the request's OWN token history; ONE multi-token "
                   "call scores draft + bonus positions and the longest "
                   "matching prefix commits. 0 (default) disables "
                   "speculation. Greedy requests only (temperature > 0 "
                   "rows fall back to single-token decode in the same "
                   "batch).")
_flags.define_flag("serving_spec_ngram", 3,
                   "Longest n-gram the self-speculation drafter matches "
                   "against the request's history (tries n down to 2).")
_flags.define_flag("serving_spec_pause", 32,
                   "Adaptive-k throttle: after 4 consecutive fruitless "
                   "speculation ticks a request pauses drafting for this "
                   "many engine ticks before probing again, so "
                   "non-repetitive traffic degrades to plain one-token "
                   "decode instead of paying verify windows that never "
                   "accept.")
_flags.define_flag("serving_max_queue", 0,
                   "Admission control: maximum requests waiting in the "
                   "scheduler queue (0 = unbounded). A submit() past it "
                   "raises QueueFullError (HTTP 503 + Retry-After).")
_flags.define_flag("serving_retry_after_s", 1.0,
                   "Base Retry-After hint (seconds) returned with 503 "
                   "queue-full responses.")
_flags.define_flag("serving_retry_after_jitter", 0.5,
                   "Forward jitter on queue-full Retry-After hints: a shed "
                   "client is told uniform[base, base * (1 + jitter)] "
                   "seconds, so a burst shed together does not retry in "
                   "lockstep. 0 disables jitter.")
_flags.define_flag("serving_prefill_bucket", 16,
                   "Length bucket (tokens) for the batched multi-prompt "
                   "prefill: a burst's unmatched suffixes pad to one "
                   "bucketed [n_prompts, max_suffix] call. 0 disables "
                   "batching.")


class QueueFullError(RuntimeError):
    """submit() rejected: the scheduler queue is at FLAGS_serving_max_queue.
    Carries the depth, the limit and a jittered Retry-After hint."""

    def __init__(self, depth: int, limit: int,
                 retry_after_s: Optional[float] = None):
        self.depth = int(depth)
        self.limit = int(limit)
        if retry_after_s is None:
            base = float(_flags.get_flag("serving_retry_after_s"))
            jitter = max(0.0, float(
                _flags.get_flag("serving_retry_after_jitter")))
            # forward only: never earlier than the base hint
            retry_after_s = base * (1.0 + random.uniform(0.0, jitter))
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"serving queue full: {self.depth} requests waiting >= "
            f"FLAGS_serving_max_queue={self.limit}; retry after "
            f"{self.retry_after_s:g}s")


class EngineDrainingError(RuntimeError):
    """submit() rejected: the engine is draining for a rolling restart."""

    def __init__(self):
        super().__init__("serving engine is draining: not admitting new "
                         "requests (in-flight work will complete)")


class ServingEngine:
    """Continuous-batching serving runtime for a GenerationMixin causal LM
    (LlamaForCausalLM, GPTForCausalLM). `device=None` means the current
    CUDA device (raising when there is none); the model must live on the
    engine's device, and its weights are read in place by the captured
    decode graphs (update them in place, never rebind them). `seed` seeds
    the sampling generator. `fuse_steps`, `spec_k`, `spec_ngram` and
    `spec_pause` default to FLAGS_serving_*."""

    def __init__(self, model, *, max_slots: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefill_bucket: Optional[int] = None,
                 device=None, seed: int = 0,
                 fuse_steps: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 spec_pause: Optional[int] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked to run on {self.device}")
        self.model = model
        model.eval()
        n_layers, n_kv, head_dim, max_pos = model._decode_geometry()
        self.block_size = int(block_size or
                              _flags.get_flag("serving_block_size"))
        self.max_slots = int(max_slots or _flags.get_flag("serving_slots"))
        self.prefill_chunk = int(prefill_chunk or
                                 _flags.get_flag("serving_prefill_chunk"))
        flag_len = int(_flags.get_flag("serving_max_model_len"))
        self.max_model_len = int(max_model_len or flag_len or max_pos)
        self.max_model_len = min(self.max_model_len, int(max_pos))
        if self.prefill_chunk % self.block_size:
            raise ValueError("serving_prefill_chunk must be a multiple of "
                             "serving_block_size")
        self.max_blocks_per_seq = -(-self.max_model_len // self.block_size)
        auto_blocks = self.max_slots * self.max_blocks_per_seq + 1
        self.num_blocks = int(num_blocks or
                              _flags.get_flag("serving_kv_blocks") or
                              auto_blocks)
        self._dtype = model._cache_dtype()
        self._geometry = (n_layers, n_kv, head_dim)
        self.prefix_cache = (bool(_flags.get_flag("serving_prefix_cache"))
                             if prefix_cache is None else bool(prefix_cache))
        self.prefill_bucket = int(
            _flags.get_flag("serving_prefill_bucket")
            if prefill_bucket is None else prefill_bucket)
        # greedy decode steps a tick (1 = no fusion)
        self.fuse_steps = int(_flags.get_flag("serving_fuse_steps")
                              if fuse_steps is None else fuse_steps)
        # self-speculative decoding (speculative.py); 0 = off
        self.spec_k = int(_flags.get_flag("serving_spec_k")
                          if spec_k is None else spec_k)
        self.spec_ngram = int(_flags.get_flag("serving_spec_ngram")
                              if spec_ngram is None else spec_ngram)
        self.spec_pause = int(_flags.get_flag("serving_spec_pause")
                              if spec_pause is None else spec_pause)
        if self.fuse_steps < 1:
            raise ValueError("fuse_steps must be >= 1")
        if self.spec_k > 0 and self.fuse_steps > 1:
            raise ValueError(
                "FLAGS_serving_fuse_steps > 1 and speculative decoding "
                "(serving_spec_k > 0) are mutually exclusive decode "
                "shapes: the fused loop carries a fixed one-token-per-"
                "step schedule that a variable-width verify window would "
                "break. Disable one of them.")
        self.pool = PagedKVPool(self.num_blocks, self.block_size, n_layers,
                                n_kv, head_dim, self._dtype, self.device)
        self.allocator = BlockAllocator(self.num_blocks, self.block_size,
                                        prefix_cache=self.prefix_cache)
        self.sched = Scheduler(self.allocator, self.max_slots,
                               self.max_model_len)
        # host mirrors of the block tables and lengths
        self._tables = np.zeros((self.max_slots, self.max_blocks_per_seq),
                                np.int32)
        self._lens = np.zeros(self.max_slots, np.int32)
        # the device copies the decode step reads, written only in place
        dev = self.device
        self._d_toks = torch.zeros(self.max_slots, dtype=torch.int64,
                                   device=dev)
        self._d_tables = torch.zeros(self.max_slots, self.max_blocks_per_seq,
                                     dtype=torch.int32, device=dev)
        self._d_lens = torch.zeros(self.max_slots, dtype=torch.int32,
                                   device=dev)
        self._d_temps = torch.zeros(self.max_slots, dtype=torch.float32,
                                    device=dev)
        # 1 for a decoding slot: idle slots keep length 0 (null block only)
        self._d_live = torch.zeros(self.max_slots, dtype=torch.int32,
                                   device=dev)
        self._caches = [PagedLayerCache(kp, vp, self._d_tables, self._d_lens)
                        for kp, vp in self.pool.layers]
        # deferred token fetches: [(tokens on the device, [(flat index,
        # slot, request), ...])], materialized by _flush_pending
        self._pending = []
        # k -> (CUDAGraph, its static [k, slots] output, launch deltas)
        self._graphs = {}
        self.graph_pool_bytes = {}
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))
        self._lock = threading.RLock()
        self._draining = False
        self.steps = 0
        self._stats = EngineStats(new_engine_id())
        self.obs = ServingObservability(self)
        if dev.type == "cuda":
            for k in sorted({1, self.fuse_steps}):
                self._capture(k)

    # -- registry-backed counter views --------------------------------------
    @property
    def prefill_programs(self) -> int:
        """Prefill calls, chunked + batched."""
        return self._stats["prefill_programs"]

    @property
    def batched_prefills(self) -> int:
        return self._stats["batched_prefills"]

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens actually computed (cache hits skip theirs)."""
        return self._stats["prefill_tokens"]

    @property
    def cow_admissions(self) -> int:
        """Full-prompt cache hits (zero prefill)."""
        return self._stats["cow_admissions"]

    @property
    def dedup_admissions(self) -> int:
        return self._stats["dedup_admissions"]

    @property
    def spec_ticks(self) -> int:
        """Ticks that ran a verify window."""
        return self._stats["spec_ticks"]

    @property
    def spec_proposed(self) -> int:
        """Draft tokens offered."""
        return self._stats["spec_proposed"]

    @property
    def spec_accepted(self) -> int:
        """Draft tokens accepted."""
        return self._stats["spec_accepted"]

    @property
    def spec_rollbacks(self) -> int:
        """Ticks that rolled back >= 1 token."""
        return self._stats["spec_rollbacks"]

    @property
    def graph_replays(self) -> int:
        """Greedy ticks that replayed a captured decode graph."""
        return self._stats["graph_replays"]

    # ------------------------------------------------------------- intake
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None,
               tier: str = "default",
               trace_ctx: Optional[dict] = None,
               prefill_only: bool = False) -> Request:
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_token_id=eos_token_id,
                      request_id=request_id, tier=tier, trace_ctx=trace_ctx,
                      prefill_only=prefill_only)
        max_queue = int(_flags.get_flag("serving_max_queue"))
        with self._lock:
            if self._draining:
                self.obs.on_shed(req, "draining")
                raise EngineDrainingError()
            depth = len(self.sched.waiting)
            if max_queue > 0 and depth >= max_queue:
                self.obs.on_shed(req, "queue_full")
                raise QueueFullError(depth, max_queue)
            self.obs.on_submit(req)
            self.sched.submit(req)
        return req

    def drain(self):
        """Stop admitting new requests (submit() raises
        EngineDrainingError) while accepted work completes."""
        with self._lock:
            self._draining = True

    def resume(self):
        """Re-open admissions after a drain()."""
        with self._lock:
            self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        """True once a draining engine has no in-flight work left."""
        with self._lock:
            return self._draining and not self.sched.has_work()

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Evict a request in any pre-finished state, releasing its slot and
        KV reservation. Returns False if it had already finished."""
        with self._lock:
            if req.state == "finished":
                return False
            self._finish(req, reason)
            return True

    # ------------------------------------------- KV-block streaming wire
    def export_kv_blocks(self, tokens: List[int]) -> List[dict]:
        """The resident full-block prefix of `tokens` as wire records, one
        an indexed block in chain order: the chain digest (hex), the
        previous link's digest, the block's token ids and the raw
        per-layer (K, V) page bytes (the pool dtype's bits, bf16 included,
        as the reference's numpy export writes them). Read-only."""
        with self._lock:
            recs = self.allocator.export_prefix(tokens)
            if not recs:
                return []
            blks = torch.tensor([r["block"] for r in recs],
                                dtype=torch.int64, device=self.device)
            # uint8 views carry any dtype's bits (numpy has no bfloat16)
            layers = [(kp[blks].cpu().view(torch.uint8).numpy(),
                       vp[blks].cpu().view(torch.uint8).numpy())
                      for kp, vp in self.pool.layers]
            return [{"digest": r["digest"].hex(), "prev": r["prev"].hex(),
                     "tokens": r["tokens"],
                     "layers": [(k[i].tobytes(), v[i].tobytes())
                                for k, v in layers]}
                    for i, r in enumerate(recs)]

    def ingest_kv_blocks(self, records: List[dict]) -> dict:
        """Admit streamed KV blocks into the pool as prefix-cache entries.
        Each record's chain link (allocator.import_block) and payload size
        are checked before anything is claimed; a failed link stops the
        chain (its descendants could never match). Idempotent: resident
        digests are deduped without touching the pool. Pages are written in
        place. Returns {"imported", "dedup", "rejected", "skipped",
        "bytes"}."""
        n_layers = len(self.pool.layers)
        kp0 = self.pool.layers[0][0]
        blk_shape = tuple(kp0.shape[1:])
        blk_bytes = kp0[0].numel() * kp0.element_size()
        imported = dedup = rejected = skipped = nbytes = 0
        with self._lock:
            prev = b""
            pend = []               # (block id, [(k bytes, v bytes), ...])
            for i, rec in enumerate(records):
                try:
                    digest = bytes.fromhex(rec["digest"])
                    rec_prev = bytes.fromhex(rec["prev"])
                    layers = rec["layers"]
                    if rec_prev != prev:
                        raise ValueError("broken chain: prev digest does "
                                         "not match the previous record")
                    if len(layers) != n_layers or any(
                            len(k) != blk_bytes or len(v) != blk_bytes
                            for k, v in layers):
                        raise ValueError("payload does not match the pool "
                                         "geometry")
                    blk, fresh = self.allocator.import_block(
                        prev, rec["tokens"], digest)
                except ValueError:
                    # a corrupt or mislabeled link: everything after it
                    # hangs off an unverifiable digest
                    rejected += 1
                    skipped += len(records) - i - 1
                    break
                except MemoryError:
                    # pool full: a hole mid-chain strands the descendants
                    skipped += len(records) - i
                    break
                prev = digest
                if fresh:
                    imported += 1
                    nbytes += 2 * n_layers * blk_bytes
                    pend.append((blk, layers))
                else:
                    dedup += 1
            if pend:
                idx = torch.tensor([b for b, _ in pend], dtype=torch.int64,
                                   device=self.device)

                def pages(li, kv):
                    raw = np.frombuffer(b"".join(a[li][kv] for _, a in pend),
                                        np.uint8).copy()
                    return (torch.from_numpy(raw).view(kp0.dtype)
                            .reshape(len(pend), *blk_shape).to(self.device))

                for li, (kp, vp) in enumerate(self.pool.layers):
                    kp[idx] = pages(li, 0)
                    vp[idx] = pages(li, 1)
        return {"imported": imported, "dedup": dedup, "rejected": rejected,
                "skipped": skipped, "bytes": nbytes}

    # ------------------------------------------------------------ tick
    @torch.no_grad()
    def step(self) -> dict:
        """One engine tick: admissions, prefill, one decode step (or
        fuse_steps greedy ones) over the running batch. Returns per-tick
        stats."""
        with self._lock:
            t0 = self.obs.tick_begin()
            admitted = self.sched.admit()
            for req in admitted:
                self.obs.on_admitted(req)
            # full-prompt cache hits never prefill
            for req in [r for r in self.sched.prefilling
                        if r._cow_src is not None]:
                self._admit_cached(req)
            if self.prefill_bucket > 0:
                batch = [r for r in self.sched.prefilling
                         if r._ws_caches is None and r.temperature <= 0.0
                         and 0 < (len(r.prompt) - r.prefill_pos)
                         <= self.prefill_chunk]
                if len(batch) >= 2:
                    self._batched_prefill(batch[:self.max_slots])
            # one chunk per tick bounds a prompt's stall of the running
            # batch; idle slots are not stalled, so a burst may prefill up
            # to one chunk per idle slot
            budget = max(1, self.max_slots - len(self.sched.running))
            for _ in range(budget):
                req = self.sched.next_prefill()
                if req is None:
                    break
                self._prefill_one_chunk(req)
                if self.sched.next_prefill() is req:
                    break   # long prompt mid-prefill: one chunk per tick
            decoded = self._decode_step() if self.sched.running else 0
            self.steps += 1
            out = {"admitted": len(admitted), "decoded_tokens": decoded,
                   **self.sched.counts()}
            self.obs.on_tick(t0, out)
            return out

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        steps = 0
        while self.sched.has_work():
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError("serving engine did not drain "
                                   f"within {max_steps} steps")
        return steps

    def generate(self, prompts, max_new_tokens: int = 16,
                 temperature: float = 0.0,
                 eos_token_id: Optional[int] = None):
        """Blocking convenience: submit all, drain, return the full
        sequences (prompt + generated) as lists of ints."""
        reqs = [self.submit(list(p), max_new_tokens=max_new_tokens,
                            temperature=temperature,
                            eos_token_id=eos_token_id) for p in prompts]
        self.run_until_idle()
        return [r.prompt + r.output_tokens for r in reqs]

    # ------------------------------------------------------ slot state
    def _set_slot(self, slot: int, tok, length: int, temp: float,
                  table) -> None:
        """Write one slot's decode state to the host mirrors and the device
        copies (in place), and mark it live. `tok` is an int or a 0-d
        device tensor (a first token whose fetch is deferred)."""
        self._tables[slot] = 0
        self._tables[slot, :len(table)] = table
        self._d_tables[slot].copy_(torch.from_numpy(self._tables[slot]))
        self._lens[slot] = length
        self._d_toks[slot] = tok
        self._d_lens[slot] = int(length)
        self._d_temps[slot] = float(temp)
        self._d_live[slot] = 1

    def _clear_slot(self, slot: int) -> None:
        """Point a finished slot at the null block with length 0: the
        blocks it held may go to a request in another slot, and the decode
        step keeps running over every slot."""
        self._tables[slot] = 0
        self._lens[slot] = 0
        self._d_tables[slot].zero_()
        self._d_toks[slot] = 0
        self._d_lens[slot] = 0
        self._d_temps[slot] = 0.0
        self._d_live[slot] = 0

    def _sample(self, logits, temps):
        """logits [n, vocab] fp32; temps [n] fp32 on device. Greedy where
        temp <= 0, else a categorical draw at that temperature."""
        nxt = torch.argmax(logits, dim=-1)
        if bool((temps > 0).any()):
            t = torch.clamp(temps, min=1e-6)[:, None]
            probs = torch.softmax(logits / t, dim=-1)
            draw = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            nxt = torch.where(temps > 0, draw, nxt)
        return nxt

    # ----------------------------------------------------------- prefill
    def _admit_cached(self, req: Request) -> None:
        """Full-prompt prefix-cache hit: every prompt block is already in
        the pool, so the request enters decode directly. The decode step
        recomputes the last prompt token (token = prompt[-1] at length
        plen - 1): its K/V write lands in the copy-on-write fork of the
        final shared block, and its logits give the first new token."""
        if req.prefill_only:
            # every prompt block is resident and indexed: nothing to
            # compute or publish (the fork frees with the reservation)
            self._finish(req, "prefill_complete")
            return
        plen = len(req.prompt)
        table = self.allocator.table(req.request_id)
        dst = int(table[plen // self.block_size - 1])
        src = int(req._cow_src)
        for kp, vp in self.pool.layers:
            kp[dst] = kp[src]
            vp[dst] = vp[src]
        self._set_slot(req.slot, req.prompt[-1], plen - 1, req.temperature,
                       table)
        self._stats.inc("cow_admissions")
        self.sched.start_running(req)
        self.obs.on_first_token(req)

    def _register(self, req: Request, table):
        """Index the prompt's full blocks now resident in the pool; adopt a
        live-dedup swap. Returns the (possibly swapped) table."""
        if not self.prefix_cache:
            return table
        self.allocator.register_prefix(req.request_id, req.prompt)
        if self.allocator.last_dedup:
            self._stats.inc("dedup_admissions")
            return self.allocator.table(req.request_id)
        return table

    def _batched_prefill(self, reqs: List[Request]) -> None:
        """Admit a burst of prompts in one model call: each row's cached
        prefix is gathered from the pool into a contiguous [n, P] workspace,
        the model runs over the padded [n, S] suffixes with per-row
        offsets, each row's first token is the argmax at its last real
        index (kept on the device, its fetch deferred), and the workspaces
        scatter back to the pages.

        Padding rows have all-null tables (their write-back lands in block
        0) and no slot. Shared prefix blocks appear in several rows' tables;
        every row scatters back the identical bytes it gathered."""
        t0 = self.obs.now()
        dev = self.device
        n = self.max_slots
        bs = self.block_size
        bucket = max(self.prefill_bucket, 1)
        suffixes = [len(r.prompt) - r.prefill_pos for r in reqs]
        S = -(-max(suffixes) // bucket) * bucket
        ctx = max(r.prefill_pos + S for r in reqs)
        # the workspace length rides the chunk grid, as in the reference
        P = -(-ctx // self.prefill_chunk) * self.prefill_chunk
        nb = P // bs
        ids = np.zeros((n, S), np.int64)
        pos = np.zeros(n, np.int32)
        tP = np.zeros((n, nb), np.int64)
        last = np.zeros(n, np.int64)
        tables = []
        for r, req in enumerate(reqs):
            take = len(req.prompt) - req.prefill_pos
            ids[r, :take] = req.prompt[req.prefill_pos:]
            pos[r] = req.prefill_pos
            table = self.allocator.table(req.request_id)
            tP[r, :min(nb, len(table))] = table[:nb]
            last[r] = take - 1
            tables.append(table)
        tP_d = torch.from_numpy(tP).to(dev)
        caches = []
        for kp, vp in self.pool.layers:
            hkv, d = kp.shape[2], kp.shape[3]
            caches.append((kp[tP_d].reshape(n, P, hkv, d),
                           vp[tP_d].reshape(n, P, hkv, d)))
        logits, ncs = self.model(torch.from_numpy(ids).to(dev),
                                 caches=caches,
                                 pos=torch.from_numpy(pos).to(dev))
        lg = logits[torch.arange(n, device=dev),
                    torch.from_numpy(last).to(dev)].float()
        first = torch.argmax(lg, dim=-1)
        flat = tP_d.reshape(-1)
        for (kp, vp), (k, v) in zip(self.pool.layers, ncs):
            hkv, d = kp.shape[2], kp.shape[3]
            kp[flat] = k.reshape(n * nb, bs, hkv, d)
            vp[flat] = v.reshape(n * nb, bs, hkv, d)
        self._stats.inc("batched_prefills")
        self._stats.inc("prefill_programs")
        computed = sum(suffixes)
        self._stats.inc("prefill_tokens", computed)
        PREFILL_TOKENS.inc(computed)
        joined = []
        flush = False
        for r, req in enumerate(reqs):
            req.prefill_pos = len(req.prompt)
            table = self._register(req, tables[r])
            self.obs.on_prefill_chunk(req, t0, suffixes[r], batched=True)
            if req.prefill_only:
                # the row rode the call for its KV only
                self._finish(req, "prefill_complete")
                continue
            self._set_slot(req.slot, first[r], len(req.prompt),
                           req.temperature, table)
            req._pending_n += 1
            joined.append((r, req.slot, req))
            self.sched.start_running(req)
            self.obs.on_first_token(req)
            if req.eos_token_id is not None or req.max_new_tokens <= 1:
                flush = True
        if joined:
            self._pending.append((first, joined))
        if flush:
            self._flush_pending()

    def _gather_workspace(self, padded: int, head: List[int]):
        """A prefill workspace whose first len(head) blocks are copied from
        the pool (prefix-cache partial hit)."""
        n_layers, n_kv, head_dim = self._geometry
        ws = init_kv_cache(1, padded, n_layers, n_kv, head_dim, self._dtype,
                           self.device)
        idx = torch.tensor(head, dtype=torch.int64, device=self.device)
        n = len(head) * self.block_size
        for (k, v), (kp, vp) in zip(ws, self.pool.layers):
            k[0, :n] = kp[idx].reshape(n, n_kv, head_dim)
            v[0, :n] = vp[idx].reshape(n, n_kv, head_dim)
        return ws

    def _prefill_one_chunk(self, req: Request) -> None:
        t0 = self.obs.now()
        n_layers, n_kv, head_dim = self._geometry
        plen = len(req.prompt)
        chunk = self.prefill_chunk
        # chunk writes start at prefix_matched (a block multiple, not
        # necessarily a chunk multiple): the workspace covers the LAST
        # chunk window, so its writes never clamp
        padded = (req.prefix_matched
                  + -(-(plen - req.prefix_matched) // chunk) * chunk)
        if req._ws_caches is None:
            if req.prefix_matched:
                mb = req.prefix_matched // self.block_size
                req._ws_caches = self._gather_workspace(
                    padded, self.allocator.table(req.request_id)[:mb])
            else:
                req._ws_caches = init_kv_cache(1, padded, n_layers, n_kv,
                                               head_dim, self._dtype,
                                               self.device)
        start = req.prefill_pos
        ids = np.zeros((1, chunk), np.int64)
        take = min(chunk, plen - start)
        ids[0, :take] = req.prompt[start:start + take]
        logits, req._ws_caches = self.model(
            torch.from_numpy(ids).to(self.device), caches=req._ws_caches,
            pos=start)
        req.prefill_pos = start + take
        self._stats.inc("prefill_programs")
        self._stats.inc("prefill_tokens", take)
        PREFILL_TOKENS.inc(take)
        self.obs.on_prefill_chunk(req, t0, take)
        if req.prefill_pos < plen:
            return
        # prompt fully prefilled: scatter the prompt-covering blocks into
        # the pages (the table is the whole worst-case reservation; decode
        # appends fill the rest), sample the first token, join decode
        table = self.allocator.table(req.request_id)
        nb = -(-plen // self.block_size)
        idx = torch.tensor(table[:nb], dtype=torch.int64, device=self.device)
        for (kp, vp), (k, v) in zip(self.pool.layers, req._ws_caches):
            write_prefix(kp, vp, k[0, :nb * self.block_size],
                         v[0, :nb * self.block_size], idx,
                         block_size=self.block_size)
        req._ws_caches = None
        table = self._register(req, table)
        if req.prefill_only:
            # disaggregated prefill: the prompt's full blocks stay resident
            # (evictable, matchable, exportable); no first token
            self._finish(req, "prefill_complete")
            return
        slot = req.slot
        lg = logits[0:1, plen - 1 - start].float()
        # a greedy request with no eos and more than one token to go never
        # needs its first token's value now: keep it on the device
        defer = (req.temperature <= 0.0 and req.eos_token_id is None
                 and req.max_new_tokens > 1)
        if defer:
            first = torch.argmax(lg, dim=-1)
            self._set_slot(slot, first[0], plen, req.temperature, table)
            self._pending.append((first, [(0, slot, req)]))
            req._pending_n += 1
        else:
            temp = torch.tensor([req.temperature], device=self.device)
            tok = int(self._sample(lg, temp)[0])
            self._set_slot(slot, tok, plen, req.temperature, table)
            req.output_tokens.append(tok)
            req._progress.set()
        self.sched.start_running(req)
        self.obs.on_first_token(req)
        if not defer:
            self._check_finished(req, slot)

    # ------------------------------------------------------------ decode
    def _out_buffer(self, k: int):
        """The static [k, slots] tokens output of a k-step greedy body."""
        return torch.zeros(k, self.max_slots, dtype=torch.int64,
                           device=self.device)

    def _decode_body(self, k: int, out) -> None:
        """k greedy decode steps over every slot, in place: model, argmax,
        the token fed back into _d_toks, lengths advanced for live slots,
        step i's tokens into out[i]. What a CUDA graph captures; the CPU
        runs it eagerly. No host sync, no tensor rebound."""
        for i in range(k):
            logits, _ = self.model(self._d_toks[:, None],
                                   caches=self._caches)
            nxt = torch.argmax(logits[:, -1, :].float(), dim=-1)
            self._d_toks.copy_(nxt)
            self._d_lens += self._d_live
            out[i].copy_(nxt)

    @torch.no_grad()
    def _capture(self, k: int) -> None:
        """Capture the k-step greedy body as a CUDA graph. Runs while every
        slot is idle (null tables, length 0, not live): the warm-up run,
        which fills the kernels' lazy state (loaded libraries, SM counts,
        cuBLAS workspaces) on the capture stream, writes only the null
        page and leaves the lengths at 0; the tokens it feeds back are
        zeroed after. Records the launch counts' deltas over the capture
        (added at every replay) and the graph pool's bytes."""
        if self.sched.running or bool(self._d_live.any()):
            raise RuntimeError("decode graphs are captured while every "
                               "slot is idle")
        out = self._out_buffer(k)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._decode_body(k, out)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        before = _gpu.launch_counts()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._decode_body(k, out)
        after = _gpu.launch_counts()
        # the segments the caching allocator holds in the graph's pool
        pool = tuple(graph.pool())
        self.graph_pool_bytes[k] = sum(
            seg["total_size"]
            for seg in torch.cuda.memory._snapshot()["segments"]
            if tuple(seg["segment_pool_id"]) == pool)
        self._d_toks.zero_()
        deltas = {n: after[n] - before[n] for n in after
                  if after[n] != before[n]}
        self._graphs[k] = (graph, out, deltas)

    def graph_launches(self, k: int) -> dict:
        """{kernel: launches} one replay of the k-step graph makes."""
        return dict(self._graphs[k][2])

    def _greedy_steps(self, k: int):
        """Run k greedy steps: replay the captured graph on a card (its
        launches added to the counts), the eager body on the CPU. Returns
        this tick's [k, slots] tokens in a buffer of its own."""
        if self.device.type == "cuda":
            graph, out, deltas = self._graphs[k]
            graph.replay()
            _gpu.add_launch_counts(deltas)
            self._stats.inc("graph_replays")
        else:
            out = self._out_buffer(k)
            self._decode_body(k, out)
        # the next replay overwrites the static output
        return out.clone()

    def _decode_step(self) -> int:
        if self.spec_k > 0:
            decoded = self._spec_step()
            if decoded is not None:
                return decoded
        t0 = self.obs.now()
        running = list(self.sched.running.items())
        if not running:
            return 0
        needs_sampling = any(req.temperature > 0.0 for _, req in running)
        # all-greedy ticks run fuse_steps steps. A slot whose budget ends
        # mid-chunk overshoots: its extra tokens are dropped at flush, and
        # its extra KV writes land in the null page or the last block of
        # its own table (the column clamps), never in a shared block
        k = 1 if needs_sampling else self.fuse_steps
        if needs_sampling:
            logits, _ = self.model(self._d_toks[:, None],
                                   caches=self._caches)
            nxt = self._sample(logits[:, -1, :].float(), self._d_temps)
            self._d_toks.copy_(nxt)
            self._d_lens += self._d_live
            toks = nxt[None]
        else:
            toks = self._greedy_steps(k)
        slots = self.max_slots
        self._pending.append((toks, [(i * slots + slot, slot, req)
                                     for i in range(k)
                                     for slot, req in running]))
        self.obs.on_decode(t0, running, k)
        # defer the fetch; flush when a value can matter: an eos id to
        # check, a budget or the context cap reached this tick
        flush = False
        for slot, req in running:
            req._pending_n += k
            self._lens[slot] += k
            if (req.eos_token_id is not None
                    or len(req.output_tokens) + req._pending_n
                    >= req.max_new_tokens
                    or int(self._lens[slot]) >= self.max_model_len):
                flush = True
        if flush:
            self._flush_pending()
        return len(running) * k

    def _flush_pending(self) -> None:
        """Fetch every deferred token (one host transfer for all pending
        ticks), append them in tick order, then run the finish checks; an
        eos-bearing request flushes every tick, so its stop is found on
        the token that emitted it. Tokens past a request's budget or its
        context cap (a fused chunk's overshoot) are dropped."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        vals = torch.cat([t.reshape(-1) for t, _ in pending]).cpu().numpy()
        touched = {}
        base = 0
        for toks, items in pending:
            for idx, slot, req in items:
                # cancelled mid-flight: its slot may hold a new request
                if req.state == "finished":
                    continue
                req._pending_n -= 1
                if len(req.output_tokens) >= min(
                        req.max_new_tokens,
                        self.max_model_len - len(req.prompt) + 1):
                    continue
                req.output_tokens.append(int(vals[base + idx]))
                touched[req.request_id] = (slot, req)
            base += toks.numel()
        for slot, req in touched.values():
            if req.eos_token_id is not None and \
                    req.eos_token_id in req.output_tokens:
                cut = req.output_tokens.index(req.eos_token_id) + 1
                del req.output_tokens[cut:]
                self._finish(req, "stop")
            elif len(req.output_tokens) >= req.max_new_tokens:
                self._finish(req, "length")
            elif int(self._lens[slot]) >= self.max_model_len:
                self._finish(req, "length")
        for _, req in touched.values():
            # wake streaming readers after the finish checks, so a reader
            # never sees tokens past an eos cut
            req._progress.set()

    def _spec_step(self) -> Optional[int]:
        """One speculative tick (reference engine.py:1163-1297 with the
        device half of its _spec_jit, :402-441), or None to fall through to
        the plain decode step when no request may draft right now (all
        paused by the adaptive throttle, sampled, or out of budget)."""
        # cheap pre-check: is anyone allowed to draft this tick?
        active = False
        for slot, req in self.sched.running.items():
            if req.temperature > 0.0:
                continue
            if req._spec is None:
                req._drafter = NgramDrafter(max_n=self.spec_ngram)
                req._spec = SpecState(self.spec_k,
                                      pause_ticks=self.spec_pause)
            if req._spec.draft_k(self.steps) > 0:
                active = True
        if not active:
            return None
        # drafting reads every emitted token's value
        self._flush_pending()
        running = list(self.sched.running.items())
        if not running:
            return 0
        # draft per slot, capped so a fully-accepted window can never
        # overrun the token budget, the context cap, or the worst-case
        # block reservation. The allocator's length advances only on spec
        # ticks (the plain tick never appends), as in the reference.
        drafts = {}
        for slot, req in running:
            if req.temperature > 0.0 or req._spec is None:
                continue
            rid = req.request_id
            room = (self.block_size * len(self.allocator.table(rid))
                    - self.allocator.seq_len(rid) - 1)
            k_r = min(req._spec.draft_k(self.steps),
                      req.max_new_tokens - len(req.output_tokens) - 1,
                      self.max_model_len - 1 - int(self._lens[slot]),
                      room)
            if k_r <= 0:
                continue
            d = req._drafter.propose(req.prompt + req.output_tokens, k_r)
            drafts[slot] = d
            if not d:
                req._spec.record(0, 0, self.steps)
        if not any(drafts.values()):
            return None     # nobody produced a draft: plain path
        # a FIXED window W = spec_k + 1; shorter (or absent) drafts are
        # masked out of the acceptance by their lengths
        W = 1 + self.spec_k
        drafted = np.zeros((self.max_slots, W - 1), np.int64)
        dls = np.zeros(self.max_slots, np.int64)
        for slot, d in drafts.items():
            drafted[slot, :len(d)] = d
            dls[slot] = len(d)
        dev = self.device
        win = torch.cat([self._d_toks[:, None],
                         torch.from_numpy(drafted).to(dev)], dim=1)
        dls_d = torch.from_numpy(dls).to(dev)
        t0 = self.obs.now()
        logits, _ = self.model(win, caches=self._caches)
        lg = logits.float()                           # [slots, W, vocab]
        greedy = torch.argmax(lg, dim=-1)
        # accepted = longest prefix where draft i + 1 equals the greedy
        # target after window position i
        ok = ((win[:, 1:] == greedy[:, :-1])
              & (torch.arange(W - 1, device=dev)[None, :] < dls_d[:, None]))
        acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        nxt = greedy.gather(1, acc[:, None])[:, 0]
        if any(req.temperature > 0.0 for _, req in running):
            # sampled riders: one token drawn from column 0's logits
            nxt = torch.where(self._d_temps > 0,
                              self._sample(lg[:, 0], self._d_temps), nxt)
        self._d_toks.copy_(nxt)
        # idle slots stay at length 0 on the null page
        self._d_lens += ((acc + 1) * self._d_live).to(torch.int32)
        fetched = torch.cat([greedy, acc[:, None], nxt[:, None]],
                            dim=1).cpu().numpy()
        greedy_h, acc_h, nxt_h = fetched[:, :W], fetched[:, W], fetched[:, -1]
        self._stats.inc("spec_ticks")
        self.obs.on_decode(t0, running, 1, kind="spec_verify", window=W)
        decoded = 0
        for slot, req in running:
            dl = int(dls[slot])
            if req.temperature > 0.0:
                req.output_tokens.append(int(nxt_h[slot]))
                self._lens[slot] += 1
                decoded += 1
                continue
            a = int(acc_h[slot])
            emitted = [int(x) for x in greedy_h[slot, :a + 1]]
            if dl:
                # allocator commit of the whole window, then EXACT rollback
                # of the rejected tail (length rewind, table trimmed down to
                # the reservation)
                rid = req.request_id
                for _ in range(dl + 1):
                    self.allocator.append_token(rid)
                    if self.allocator.last_fork is not None:
                        raise RuntimeError(
                            "speculative append forked a shared block: "
                            "decode writes must only land in private "
                            "blocks")
                if a < dl:
                    self.allocator.rollback(rid, dl - a)
                    self._stats.inc("spec_rollbacks")
                    self.obs.on_rollback(req, dl - a)
                # record() also advances the global serving_spec_* counters
                req._spec.record(dl, a, self.steps)
                self._stats.inc("spec_proposed", dl)
                self._stats.inc("spec_accepted", a)
            req.output_tokens.extend(emitted)
            self._lens[slot] += a + 1
            decoded += len(emitted)
        for slot, req in running:
            if req.eos_token_id is not None and \
                    req.eos_token_id in req.output_tokens:
                cut = req.output_tokens.index(req.eos_token_id) + 1
                del req.output_tokens[cut:]
                self._finish(req, "stop")
            elif len(req.output_tokens) >= req.max_new_tokens:
                del req.output_tokens[req.max_new_tokens:]
                self._finish(req, "length")
            elif int(self._lens[slot]) >= self.max_model_len:
                self._finish(req, "length")
        for _, req in running:
            req._progress.set()
        return decoded

    def _check_finished(self, req: Request, slot: int) -> None:
        if req.eos_token_id is not None and \
                req.output_tokens[-1] == req.eos_token_id:
            self._finish(req, "stop")
        elif len(req.output_tokens) >= req.max_new_tokens:
            self._finish(req, "length")
        elif int(self._lens[slot]) >= self.max_model_len:
            self._finish(req, "length")

    def _finish(self, req: Request, reason: str) -> None:
        slot = req.slot
        self.sched.finish(req, reason)
        req._pending_n = 0
        if slot is not None:
            self._clear_slot(slot)
        self.obs.on_finish(req, reason)

    # ------------------------------------------------------------ status
    def snapshot_output(self, req: Request):
        """Consistent (tokens, state, finish_reason) for streaming readers:
        taken under the engine lock, so a reader never races a flush's eos
        cut."""
        with self._lock:
            return list(req.output_tokens), req.state, req.finish_reason

    def stats(self) -> dict:
        """The reference's JSON snapshot, taken under the engine lock so a
        /stats scrape during streaming sees one tick, not a torn read."""
        with self._lock:
            return {
                "steps": self.steps,
                "kv": self.allocator.occupancy_report(),
                "prefix_cache": self.prefix_cache,
                "prefill_programs": self.prefill_programs,
                "batched_prefills": self.batched_prefills,
                "prefill_tokens": self.prefill_tokens,
                "cow_admissions": self.cow_admissions,
                "dedup_admissions": self.dedup_admissions,
                "speculative": {
                    "enabled": self.spec_k > 0,
                    "k": self.spec_k,
                    "ticks": self.spec_ticks,
                    "proposed": self.spec_proposed,
                    "accepted": self.spec_accepted,
                    "rollbacks": self.spec_rollbacks,
                    "acceptance": (self.spec_accepted / self.spec_proposed
                                   if self.spec_proposed else 0.0),
                },
                **self.sched.counts(),
            }
