"""ServingEngine: continuous-batching decode over the paged KV pool
(counterpart of paddle_tpu/serving/engine.py:163).

One engine tick (`step()`) = admit -> prefill -> one decode step:

  * decode runs the model once over a fixed set of slots: every running
    sequence contributes its last token; the paged decode kernel reads each
    slot's own block table and length. Idle slots point at the null block 0
    with length 0, write their garbage KV there and their outputs are
    ignored. Greedy and per-slot temperature sampling happen on the device.
  * prefill runs the model's contiguous cached path in a private workspace,
    one bounded chunk per tick per prompt (a burst may prefill up to one
    chunk per idle slot in a tick), then scatters the finished prefix into
    the sequence's pages and joins the decode batch. A partial prefix-cache
    hit gathers the cached blocks into the workspace first; a full-prompt
    hit joins decode directly by copy-on-write of its last block; a burst of
    short greedy prompts prefills in one batched call with per-row offsets.

  * self-speculative decoding (`spec_k > 0`, speculative.py): each greedy
    request drafts up to k tokens by n-gram lookup over its own history;
    one model call scores a fixed window of W = spec_k + 1 tokens a slot
    over the paged pool (the verify kernel); the longest draft prefix that
    matches the greedy targets is kept with the bonus token, and the
    rejected tail is rolled back exactly (allocator rollback and the
    device lengths). Sampled requests ride the window with no draft and
    take one token, drawn from the first column's logits. A tick where
    nobody drafts runs the plain decode step.

Decode state (tokens, block tables, lengths, temperatures, live-slot mask)
lives in device tensors updated in place, as do the KV pages; host mirrors
keep the bookkeeping. Each tick fetches its sampled tokens to the host (the
reference's jit cache, buffer donation and deferred token fetch have no
counterpart here).

Waiting for later slices: fused multi-step decode (`fuse_steps`),
KV-block export/ingest, prefill-only requests, the HTTP server and the
fleet.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..core import flags as _flags
from ..core.place import resolve_device
from ..models.generation import init_kv_cache
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
                   "scheduler queue (0 = unbounded).")
_flags.define_flag("serving_prefill_bucket", 16,
                   "Length bucket (tokens) for the batched multi-prompt "
                   "prefill: a burst's unmatched suffixes pad to one "
                   "bucketed [n_prompts, max_suffix] call. 0 disables "
                   "batching.")


class QueueFullError(RuntimeError):
    """submit() rejected: the scheduler queue is at FLAGS_serving_max_queue."""

    def __init__(self, depth: int, limit: int):
        self.depth = int(depth)
        self.limit = int(limit)
        super().__init__(
            f"serving queue full: {self.depth} requests waiting >= "
            f"FLAGS_serving_max_queue={self.limit}")


class EngineDrainingError(RuntimeError):
    """submit() rejected: the engine is draining for a rolling restart."""

    def __init__(self):
        super().__init__("serving engine is draining: not admitting new "
                         "requests (in-flight work will complete)")


class ServingEngine:
    """Continuous-batching serving runtime for a GenerationMixin causal LM
    (LlamaForCausalLM, GPTForCausalLM). `device=None` means the current
    CUDA device (raising when there is none); the model must live on the
    engine's device. `seed` seeds the sampling generator. `spec_k`,
    `spec_ngram` and `spec_pause` default to FLAGS_serving_spec_*."""

    def __init__(self, model, *, max_slots: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefill_bucket: Optional[int] = None,
                 device=None, seed: int = 0,
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
        # self-speculative decoding (speculative.py); 0 = off
        self.spec_k = int(_flags.get_flag("serving_spec_k")
                          if spec_k is None else spec_k)
        self.spec_ngram = int(_flags.get_flag("serving_spec_ngram")
                              if spec_ngram is None else spec_ngram)
        self.spec_pause = int(_flags.get_flag("serving_spec_pause")
                              if spec_pause is None else spec_pause)
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
        # the device copies the decode step reads, updated in place per slot
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
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))
        self._lock = threading.RLock()
        self._draining = False
        self.steps = 0
        self._stats = EngineStats(new_engine_id())
        self.obs = ServingObservability(self)

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

    # ------------------------------------------------------------- intake
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None) -> Request:
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_token_id=eos_token_id,
                      request_id=request_id)
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

    # ------------------------------------------------------------ tick
    @torch.no_grad()
    def step(self) -> dict:
        """One engine tick: admissions, prefill, one decode step over the
        running batch. Returns per-tick stats."""
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
    def _set_slot(self, slot: int, tok: int, length: int, temp: float,
                  table) -> None:
        """Write one slot's decode state to the host mirrors and the device
        copies, and mark it live."""
        self._tables[slot] = 0
        self._tables[slot, :len(table)] = table
        self._d_tables[slot].copy_(torch.from_numpy(self._tables[slot]))
        self._lens[slot] = length
        self._d_toks[slot] = int(tok)
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
        index, and the workspaces scatter back to the pages.

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
        first = torch.argmax(lg, dim=-1).cpu().numpy()
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
        for r, req in enumerate(reqs):
            req.prefill_pos = len(req.prompt)
            table = self._register(req, tables[r])
            self._set_slot(req.slot, int(first[r]), len(req.prompt),
                           req.temperature, table)
            req.output_tokens.append(int(first[r]))
            self.obs.on_prefill_chunk(req, t0, suffixes[r], batched=True)
            self.sched.start_running(req)
            self.obs.on_first_token(req)
            self._check_finished(req, req.slot)

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
        slot = req.slot
        temp = torch.tensor([req.temperature], device=self.device)
        first = int(self._sample(logits[0:1, plen - 1 - start].float(),
                                 temp)[0])
        self._set_slot(slot, first, plen, req.temperature, table)
        req.output_tokens.append(first)
        self.sched.start_running(req)
        self.obs.on_first_token(req)
        self._check_finished(req, slot)

    # ------------------------------------------------------------ decode
    def _paged_caches(self):
        return [PagedLayerCache(kp, vp, self._d_tables, self._d_lens)
                for kp, vp in self.pool.layers]

    def _decode_step(self) -> int:
        if self.spec_k > 0:
            decoded = self._spec_step()
            if decoded is not None:
                return decoded
        t0 = self.obs.now()
        running = list(self.sched.running.items())
        logits, _ = self.model(self._d_toks[:, None],
                               caches=self._paged_caches())
        nxt = self._sample(logits[:, -1, :].float(), self._d_temps)
        self._d_toks.copy_(nxt)
        self._d_lens += self._d_live
        toks = nxt.cpu().numpy()
        self.obs.on_decode(t0, running, 1)
        for slot, req in running:
            t = int(toks[slot])
            req.output_tokens.append(t)
            self._lens[slot] += 1
            self._check_finished(req, slot)
        return len(running)

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
        running = list(self.sched.running.items())
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
        logits, _ = self.model(win, caches=self._paged_caches())
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
        if slot is not None:
            self._clear_slot(slot)
        self.obs.on_finish(req, reason)

    # ------------------------------------------------------------ status
    def stats(self) -> dict:
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
