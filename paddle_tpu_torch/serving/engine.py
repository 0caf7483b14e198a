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
    output. A tick with a sampled row runs one step (the reference's
    `_decode_jit(sampled=True)`): the same body with a categorical draw at
    each slot's temperature where it is > 0.
  * token fetches are deferred (the reference's `_pending` and
    `_flush_pending`): each tick's tokens stay on the device until a
    value can matter (a request with an eos id, one at its budget or
    context cap, or a speculative tick that drafts), then every pending
    tick comes to the host in one transfer.
  * prefill runs the model's contiguous cached path in a workspace, one
    bounded chunk per tick per prompt (a burst may prefill up to one chunk
    per idle slot in a tick), then scatters the finished prefix into the
    sequence's pages and joins the decode batch. Prompts prefill in FCFS
    order and a tick moves on past a prompt only once it is done, so one
    prompt at most is mid-prefill: the workspace is the engine's one
    prefill lane, allocated once, long enough for any prompt's last chunk
    window. A chunk attends over the lane's first rows up to the chunk
    multiple that covers it; stale rows of earlier prompts there are
    masked. A partial prefix-cache hit gathers the cached blocks into the
    lane's head first; a full-prompt hit joins decode directly by
    copy-on-write of its last block; a burst of short greedy prompts
    prefills in one batched call with per-row offsets (the reference's
    `_batched_prefill_jit`).
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
lives in device tensors written only in place, as are the KV pages and the
prefill lane, so a captured graph reads them at every replay; host mirrors
keep the bookkeeping.

The engine's compiled programs, the counterparts of the reference's jitted
ones, are graph bodies of five kinds: `decode` (k greedy steps, k = 1 and
fuse_steps), `sampled` (one step with the draw), `verify` (the window of
W = spec_k + 1), `prefill` (one chunk, one body for each key length,
a multiple of the chunk up to the lane's) and `batched_prefill` (a burst,
one body for each (S, P): the rows' suffix length S, the prefill bucket
times a power of two up to the chunk, and the workspace length P, the
chunk times a power of two up to the longest context a row can need; the
reference compiles one program for each (S, P) on the bucket and chunk
grids, and a coarser grid pads more, which no real row's query sees). On a
card each body is captured as a CUDA graph at construction and every tick
of its kind replays it; on the CPU the same body runs eagerly. A body reads
its per-call inputs (drafts and their lengths; a chunk's ids, position and
the row its logits are kept for; a burst's ids, offsets, last indices and
block tables) from a static device tensor that the host fills with one
non-blocking copy from a pinned buffer before the replay.

A batched prefill's workspace holds one layer: the model asks for layer
l's cache after layer l - 1 has run (the models zip their layers with the
caches), so `_LayerWorkspace` scatters layer l - 1's suffix blocks back to
its pages and gathers layer l's rows into the same [n, P] buffers then.
Only the suffix blocks go back (a row's cached prefix is unchanged), and
those are the row's own or the null page, so no two rows write one live
block; padding rows' tables are null, so their writes land in block 0.

The graphs' rules: capture while every slot is idle (the warm-up run
executes the body, which then writes only the null page and the lane);
never rebind a static tensor (`_d_*`, the lane, the pool's pages, the
model's weights); a replay runs no kernel wrapper, so the launch counts'
deltas over the capture are added at every replay (ops/gpu
`add_launch_counts`); the sampling generator is registered with every graph
that draws, so each replay draws fresh numbers and eager draws interleave
with replays; every graph shares one memory pool (no two run at once). A
capture or replay that fails raises: there is no eager path on a card.
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
from .observability import (GRAPH_KINDS, GRAPH_POOL_BYTES, PREFILL_TOKENS,
                            EngineStats, ServingObservability, new_engine_id)
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


class _Staging:
    """Per-call int64 inputs of a graph body: the host fills `host()` (a
    numpy view), then `push()` copies it into `dev`, the static tensor the
    body reads, with one non-blocking copy. On a card the host buffer is
    pinned, and `host()` first waits for the last copy out of it."""

    def __init__(self, shape, device):
        cuda = device.type == "cuda"
        self.dev = torch.zeros(shape, dtype=torch.int64, device=device)
        self._host = torch.zeros(shape, dtype=torch.int64, pin_memory=cuda)
        self._copied = torch.cuda.Event() if cuda else None

    def host(self) -> np.ndarray:
        if self._copied is not None:
            self._copied.synchronize()
        return self._host.numpy()

    def push(self) -> None:
        self.dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class _LayerWorkspace:
    """The caches a batched prefill hands the model: one K and one V buffer
    [n, P, kv_heads, head_dim], shared by every layer. Iterating gathers
    layer l's blocks (`table`, [n * nb]) from its pages into the buffers,
    after writing layer l - 1's suffix blocks (`src` rows of the buffers)
    back to their pages (`dst`); `finish()` writes the last layer's.
    The buffers hold one layer at a time, so the model must pull the
    layers in order, once: only `caches[0]` may be indexed (the models
    read it to pick their cached path), and a second iteration raises."""

    def __init__(self, layers, wk, wv, n, P, table, src, dst):
        self.layers = layers
        self._flat = (wk, wv)
        self._views = tuple(w.view(n, P, *w.shape[2:]) for w in (wk, wv))
        self._table, self._src, self._dst = table, src, dst
        self._done = 0
        self._iterated = False

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        if i != 0:
            raise IndexError("a batched prefill's caches hold one layer at "
                             "a time: only caches[0] may be indexed")
        return self._views

    def _scatter(self, li):
        for page, w in zip(self.layers[li], self._flat):
            page.index_copy_(0, self._dst, w.index_select(0, self._src))

    def __iter__(self):
        if self._iterated:
            raise RuntimeError("a batched prefill's caches are iterated "
                               "once, layer by layer")
        self._iterated = True
        return self._layers()

    def _layers(self):
        for li, pages in enumerate(self.layers):
            if li:
                self._scatter(li - 1)
            for page, w in zip(pages, self._flat):
                torch.index_select(page, 0, self._table, out=w)
            self._done = li + 1
            yield self._views

    def finish(self):
        if self._done != len(self.layers):
            raise RuntimeError(f"the model ran {self._done} of "
                               f"{len(self.layers)} layers' caches")
        self._scatter(self._done - 1)


def _doubling(unit: int, top: int) -> List[int]:
    """unit, 2 unit, 4 unit, ... below top, then top."""
    out, v = [], unit
    while v < top:
        out.append(v)
        v *= 2
    return out + [top]


class ServingEngine:
    """Continuous-batching serving runtime for a GenerationMixin causal LM
    (LlamaForCausalLM, GPTForCausalLM). `device=None` means the current
    CUDA device (raising when there is none); the model must live on the
    engine's device, and its weights are read in place by the captured
    graphs (update them in place, never rebind them). `seed` seeds
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
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))
        # the graph bodies: (kind, size) -> (body, its static output)
        slots = self.max_slots
        self._bodies = {}
        # decode and sampled bodies write [k, slots] tokens
        for k in sorted({1, self.fuse_steps}):
            self._bodies[("decode", k)] = (
                lambda out, k=k: self._decode_body(k, out, sampled=False),
                torch.zeros(k, slots, dtype=torch.int64, device=dev))
        self._bodies[("sampled", 1)] = (
            lambda out: self._decode_body(1, out, sampled=True),
            torch.zeros(1, slots, dtype=torch.int64, device=dev))
        if self.spec_k > 0:
            W = self.spec_k + 1
            # columns: the W - 1 drafts, then the draft length
            self._spec_in = _Staging((slots, W), dev)
            self._bodies[("verify", W)] = (
                self._verify_body,
                torch.zeros(slots, W + 2, dtype=torch.int64, device=dev))
        # the prefill lane: a workspace long enough for any chunk window
        # (padded <= plen + chunk - 1, a block multiple), rounded up to the
        # chunk, and its inputs (the chunk's ids, its position, the row
        # kept for the first token); one body a key length, sharing the
        # output (the kept row's fp32 logits, sized by the first run, which
        # is eager)
        chunk = self.prefill_chunk
        worst = ((self.max_model_len + chunk - 2)
                 // self.block_size * self.block_size)
        self.lane_len = -(-worst // chunk) * chunk
        self._lane = init_kv_cache(1, self.lane_len, n_layers, n_kv,
                                   head_dim, self._dtype, dev)
        self._lane_in = _Staging(chunk + 2, dev)
        self._lane_owner = None
        pf_out = torch.zeros(0, dtype=torch.float32, device=dev)
        # longest first: a shorter body's capture then reuses the blocks the
        # longer one freed in the shared pool
        for keys in range(self.lane_len, 0, -chunk):
            self._bodies[("prefill", keys)] = (
                lambda out, keys=keys: self._prefill_body(keys, out), pf_out)
        # the batched prefill's (S, P) grid and its inputs: per row the ids
        # [S], the offset, the last real index and the workspace's block
        # table [P / block_size]; one output, each row's first token
        if self.prefill_bucket > 0:
            bucket = self.prefill_bucket
            self._bp_S = _doubling(bucket, -(-chunk // bucket) * bucket)
            s_top = self._bp_S[-1]
            self._bp_P = _doubling(
                chunk, -(-(self.max_model_len - 1 + s_top) // chunk) * chunk)
            self._bp_in = _Staging(
                (slots, s_top + 2 + self._bp_P[-1] // self.block_size), dev)
            bp_out = torch.zeros(slots, dtype=torch.int64, device=dev)
            for P in reversed(self._bp_P):
                for S in reversed(self._bp_S):
                    self._bodies[("batched_prefill", (S, P))] = (
                        lambda out, S=S, P=P: self._batched_body(S, P, out),
                        bp_out)
        # (kind, size) -> (CUDAGraph, launch deltas a replay adds)
        self._graphs = {}
        # bytes each kind's captures added to the shared graph pool
        self.graph_pool_bytes = {kind: 0 for kind in GRAPH_KINDS}
        self._lock = threading.RLock()
        self._draining = False
        self.steps = 0
        self._stats = EngineStats(new_engine_id())
        self.obs = ServingObservability(self)
        if dev.type == "cuda":
            # one pool and one capture stream: the caching allocator reuses
            # a block only on the stream that freed it, so captures on one
            # stream share their scratch memory
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
            # the largest bodies first: later captures reuse the blocks
            # they freed in the shared pool
            for key in sorted(self._bodies,
                              key=lambda k: k[0] != "batched_prefill"):
                self._capture(key)

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
        """Graph replays of every kind."""
        return sum(self._stats[f"replays_{kind}"] for kind in GRAPH_KINDS)

    def graph_stats(self) -> dict:
        """Replays, ticks (prefill: single-prompt chunks; batched_prefill:
        bursts) and graph pool bytes by kind: on a card replays equal
        ticks, on the CPU replays are 0."""
        ticks = {"decode": self._stats["decode_ticks"],
                 "sampled": self._stats["sampled_ticks"],
                 "verify": self.spec_ticks,
                 "prefill": self._stats["prefill_chunks"],
                 "batched_prefill": self.batched_prefills}
        return {"replays": {kind: self._stats[f"replays_{kind}"]
                            for kind in GRAPH_KINDS},
                "ticks": ticks, "pool_bytes": dict(self.graph_pool_bytes)}

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
            # one gather and one copy to the host, [layer, K/V, block, ...]:
            # a copy per page would wait for the card once per page, behind
            # whatever else is queued on it. uint8 views carry any dtype's
            # bits (numpy has no bfloat16)
            raw = torch.stack([torch.stack((kp[blks], vp[blks]))
                               for kp, vp in self.pool.layers]).cpu()
            raw = raw.view(torch.uint8).numpy()
            return [{"digest": r["digest"].hex(), "prev": r["prev"].hex(),
                     "tokens": r["tokens"],
                     "layers": [(kv[0, i].tobytes(), kv[1, i].tobytes())
                                for kv in raw]}
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
                # one copy to the card, [layer, K/V, block, ...]
                raw = bytearray(b"".join(a[li][kv] for li in range(n_layers)
                                         for kv in (0, 1) for _, a in pend))
                pages = (torch.frombuffer(raw, dtype=torch.uint8)
                         .view(kp0.dtype)
                         .reshape(n_layers, 2, len(pend), *blk_shape)
                         .to(self.device))
                for (kp, vp), kv in zip(self.pool.layers, pages):
                    kp.index_copy_(0, idx, kv[0])
                    vp.index_copy_(0, idx, kv[1])
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
        temp <= 0, else a categorical draw at that temperature from the
        engine's generator. Always draws, so it reads nothing on the host
        (torch.multinomial's checks of a one-sample draw run on the
        device, so a CUDA graph captures it)."""
        greedy = torch.argmax(logits, dim=-1)
        t = torch.clamp(temps, min=1e-6)[:, None]
        probs = torch.softmax(logits / t, dim=-1)
        draw = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(temps > 0, draw, greedy)

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

    def _batched_body(self, S: int, P: int, out) -> None:
        """A burst of up to max_slots prompts in one model call (the
        reference's _batched_prefill_jit at this (S, P)): each row's blocks
        gathered into an [n, P] workspace a layer at a time
        (_LayerWorkspace), the model over the padded [n, S] suffixes at
        their per-row offsets, each row's suffix blocks scattered back to
        its pages, and the argmax at each row's last real index into out
        [n]. What a CUDA graph captures; the CPU runs it eagerly."""
        dev = self.device
        n, bs = self.max_slots, self.block_size
        nb, ns = P // bs, -(-S // bs)
        s_top = self._bp_S[-1]
        x = self._bp_in.dev
        pos = x[:, s_top]
        table = x[:, s_top + 2:s_top + 2 + nb]
        # a row's offset is a block multiple and P covers offset + S, so
        # its suffix is the ns blocks from column pos / bs
        cols = (pos // bs)[:, None] + torch.arange(ns, device=dev)[None]
        src = (torch.arange(n, device=dev)[:, None] * nb + cols).reshape(-1)
        dst = table.gather(1, cols).reshape(-1)
        _, n_kv, head_dim = self._geometry
        wk = torch.empty(n * nb, bs, n_kv, head_dim, dtype=self._dtype,
                         device=dev)
        ws = _LayerWorkspace(self.pool.layers, wk, torch.empty_like(wk), n,
                             P, table.reshape(-1), src, dst)
        logits, _ = self.model(x[:, :S], caches=ws, pos=pos)
        ws.finish()
        lg = logits[torch.arange(n, device=dev), x[:, s_top + 1]].float()
        out.copy_(torch.argmax(lg, dim=-1))

    def _batched_prefill(self, reqs: List[Request]) -> None:
        """Admit a burst of prompts in one call of the batched body: rows
        are the burst's unmatched suffixes, padded to S on the grid (at
        least the reference's bucketed length), over a workspace of P
        tokens on the grid (at least every row's offset + S); each row's
        first token is kept on the device, its fetch deferred. Padding
        rows have all-null tables and no slot."""
        t0 = self.obs.now()
        bs = self.block_size
        bucket = self.prefill_bucket
        suffixes = [len(r.prompt) - r.prefill_pos for r in reqs]
        S_ref = -(-max(suffixes) // bucket) * bucket
        S = next(v for v in self._bp_S if v >= S_ref)
        ctx = max(r.prefill_pos + S for r in reqs)
        P = next(v for v in self._bp_P if v >= ctx)
        nb = P // bs
        s_top = self._bp_S[-1]
        x = self._bp_in.host()
        x[:] = 0
        tables = []
        for r, req in enumerate(reqs):
            take = len(req.prompt) - req.prefill_pos
            x[r, :take] = req.prompt[req.prefill_pos:]
            x[r, s_top] = req.prefill_pos
            x[r, s_top + 1] = take - 1
            table = self.allocator.table(req.request_id)
            m = min(nb, len(table))
            x[r, s_top + 2:s_top + 2 + m] = table[:m]
            tables.append(table)
        self._bp_in.push()
        # the next run overwrites the static output
        first = self._run(("batched_prefill", (S, P))).clone()
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

    def _gather_workspace(self, ws, head: List[int]) -> None:
        """Copy the pool blocks `head` into the head of the prefill lane
        (prefix-cache partial hit)."""
        _, n_kv, head_dim = self._geometry
        idx = torch.tensor(head, dtype=torch.int64, device=self.device)
        n = len(head) * self.block_size
        for (k, v), (kp, vp) in zip(ws, self.pool.layers):
            k[0, :n] = kp[idx].reshape(n, n_kv, head_dim)
            v[0, :n] = vp[idx].reshape(n, n_kv, head_dim)

    def _prefill_body(self, keys: int, out) -> None:
        """One chunk of one prompt in the prefill lane's first `keys` rows
        (pos + chunk <= keys): the model's contiguous cached path over the
        chunk's ids at its position (a 0-d device tensor), the kept row's
        fp32 logits into out [1, vocab]. What a CUDA graph captures; the
        CPU runs it eagerly."""
        ws = [(k[:, :keys], v[:, :keys]) for k, v in self._lane]
        c = self.prefill_chunk
        x = self._lane_in.dev
        logits, _ = self.model(x[None, :c], caches=ws, pos=x[c])
        row = logits[0].index_select(0, x[c + 1:]).float()
        # allocates on the first run, which is eager; a no-op after
        out.resize_(row.shape).copy_(row)

    def _prefill_one_chunk(self, req: Request) -> None:
        t0 = self.obs.now()
        plen = len(req.prompt)
        chunk = self.prefill_chunk
        # chunk writes start at prefix_matched (a block multiple, not
        # necessarily a chunk multiple); the lane covers the last window
        ws = self._lane
        if req._ws_caches is None:
            owner = self._lane_owner
            if owner is not None and owner is not req \
                    and owner._ws_caches is not None:
                raise RuntimeError("a prompt started prefilling while "
                                   "another one is mid-prefill")
            self._lane_owner = req
            req._ws_caches = ws
            if req.prefix_matched:
                mb = req.prefix_matched // self.block_size
                self._gather_workspace(
                    ws, self.allocator.table(req.request_id)[:mb])
        start = req.prefill_pos
        take = min(chunk, plen - start)
        x = self._lane_in.host()
        x[:] = 0
        x[:take] = req.prompt[start:start + take]
        x[chunk] = start
        x[chunk + 1] = plen - 1 - start if start + take == plen else 0
        self._lane_in.push()
        lg = self._run(("prefill", -(-(start + chunk) // chunk) * chunk))
        req.prefill_pos = start + take
        self._stats.inc("prefill_programs")
        self._stats.inc("prefill_chunks")
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
        for (kp, vp), (k, v) in zip(self.pool.layers, ws):
            write_prefix(kp, vp, k[0, :nb * self.block_size],
                         v[0, :nb * self.block_size], idx,
                         block_size=self.block_size)
        req._ws_caches = None
        self._lane_owner = None
        table = self._register(req, table)
        if req.prefill_only:
            # disaggregated prefill: the prompt's full blocks stay resident
            # (evictable, matchable, exportable); no first token
            self._finish(req, "prefill_complete")
            return
        slot = req.slot
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
    def _decode_body(self, k: int, out, sampled: bool) -> None:
        """k decode steps over every slot, in place: model, argmax (with
        `sampled`, the draw where a slot's temperature is > 0), the token
        fed back into _d_toks, lengths advanced for live slots, step i's
        tokens into out[i]. What a CUDA graph captures; the CPU runs it
        eagerly. No host read, no tensor rebound."""
        for i in range(k):
            logits, _ = self.model(self._d_toks[:, None],
                                   caches=self._caches)
            lg = logits[:, -1, :].float()
            nxt = (self._sample(lg, self._d_temps) if sampled
                   else torch.argmax(lg, dim=-1))
            self._d_toks.copy_(nxt)
            self._d_lens += self._d_live
            out[i].copy_(nxt)

    def _verify_body(self, out) -> None:
        """The speculative verify window (the reference's _spec_jit), in
        place: window = [_d_toks | the staged drafts], the model over it,
        the greedy targets, the accepted prefix `acc` (draft i + 1 matches
        the target after position i, within the slot's draft length), the
        next token (target acc; for a sampled rider, a draw from column 0's
        logits), _d_toks fed back and lengths advanced by acc + 1 for live
        slots; out [slots, W + 2] = [greedy | acc | nxt]. What a CUDA graph
        captures; the CPU runs it eagerly."""
        W = self.spec_k + 1
        x = self._spec_in.dev
        win = torch.cat([self._d_toks[:, None], x[:, :W - 1]], dim=1)
        logits, _ = self.model(win, caches=self._caches)
        lg = logits.float()                           # [slots, W, vocab]
        greedy = torch.argmax(lg, dim=-1)
        ok = ((win[:, 1:] == greedy[:, :-1])
              & (torch.arange(W - 1, device=win.device)[None, :]
                 < x[:, W - 1:]))
        acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        nxt = greedy.gather(1, acc[:, None])[:, 0]
        nxt = torch.where(self._d_temps > 0,
                          self._sample(lg[:, 0], self._d_temps), nxt)
        self._d_toks.copy_(nxt)
        # idle slots stay at length 0 on the null page
        self._d_lens += ((acc + 1) * self._d_live).to(torch.int32)
        out[:, :W].copy_(greedy)
        out[:, W].copy_(acc)
        out[:, W + 1].copy_(nxt)

    def _pool_bytes(self) -> int:
        """Bytes of the segments the caching allocator holds in the graphs'
        shared pool."""
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory._snapshot()["segments"]
                   if tuple(seg["segment_pool_id"]) == pool)

    @torch.no_grad()
    def _capture(self, key) -> None:
        """Capture one graph body as a CUDA graph in the shared pool. Runs
        while every slot is idle (null tables, length 0, not live): the
        warm-up run, which fills the kernels' lazy state (loaded
        libraries, SM counts, cuBLAS workspaces) on the capture stream,
        writes only the null page and the lane (a batched body's staged
        inputs are zeros: null tables) and leaves the lengths at 0;
        the tokens it feeds back are zeroed after. A body that draws has
        the engine's generator registered. Records the launch counts'
        deltas over the capture (added at every replay) and the bytes the
        capture added to the pool."""
        if self.sched.running or bool(self._d_live.any()):
            raise RuntimeError("graphs are captured while every slot is "
                               "idle")
        body, out = self._bodies[key]
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            body(out)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        if key[0] in ("sampled", "verify"):
            graph.register_generator_state(self._gen)
        pool_before = self._pool_bytes()
        # this thread's launches only: another engine's thread may replay
        # its graphs meanwhile
        with _gpu.recording() as deltas, torch.cuda.graph(
                graph, pool=self._graph_pool, stream=stream,
                capture_error_mode="thread_local"):
            body(out)
        self.graph_pool_bytes[key[0]] += self._pool_bytes() - pool_before
        GRAPH_POOL_BYTES.set(self.graph_pool_bytes[key[0]],
                             engine=self._stats.eid, kind=key[0])
        self._d_toks.zero_()
        self._graphs[key] = (graph, deltas)

    def graph_launches(self, kind: str, size: int) -> dict:
        """{kernel: launches} one replay of a graph makes (size: k for
        decode and sampled, W for verify, the key length for prefill,
        (S, P) for batched_prefill)."""
        return dict(self._graphs[(kind, size)][1])

    @torch.no_grad()
    def _run(self, key):
        """Run one graph body: on a card replay its captured graph (the
        launch counts' deltas added, the replay counted by kind), on the
        CPU the eager body. Returns the body's static output, which the
        next run of the body overwrites."""
        body, out = self._bodies[key]
        if self.device.type == "cuda":
            graph, deltas = self._graphs[key]
            graph.replay()
            _gpu.add_launch_counts(deltas)
            self._stats.inc(f"replays_{key[0]}")
        else:
            body(out)
        return out

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
        # all-greedy ticks run fuse_steps steps, a tick with a sampled row
        # one. A slot whose budget ends mid-chunk overshoots: its extra
        # tokens are dropped at flush, and its extra KV writes land in the
        # null page or the last block of its own table (the column clamps),
        # never in a shared block
        kind = "sampled" if needs_sampling else "decode"
        k = 1 if needs_sampling else self.fuse_steps
        # the next run overwrites the static output
        toks = self._run((kind, k)).clone()
        self._stats.inc(f"{kind}_ticks")
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
        x = self._spec_in.host()
        x[:] = 0
        for slot, d in drafts.items():
            x[slot, :len(d)] = d
            x[slot, W - 1] = len(d)
        dls = x[:, W - 1].copy()
        self._spec_in.push()
        t0 = self.obs.now()
        # one transfer brings [greedy | acc | nxt] to the host
        fetched = self._run(("verify", W)).cpu().numpy()
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

    def stats(self, graphs: bool = False) -> dict:
        """The reference's JSON snapshot, taken under the engine lock so a
        /stats scrape during streaming sees one tick, not a torn read. With
        `graphs`, also "graphs": graph_stats() (the reference has no such
        key)."""
        with self._lock:
            extra = {"graphs": self.graph_stats()} if graphs else {}
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
                **extra,
            }
