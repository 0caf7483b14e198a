"""Paged KV-cache block allocator (host-side bookkeeping) with automatic
prefix caching (counterpart of paddle_tpu/serving/blocks.py:101).

The device pool (paged.py) is a fixed array of NUM_BLOCKS fixed-size token
blocks; this allocator owns which block belongs to which sequence. The free
list is a stack (LIFO reuse), a sequence's block table is a list, and
free() releases the whole table in one pass.

Block 0 is reserved as the NULL block: inactive decode slots point their
block tables at it so the decode step can write their (masked, garbage) KV
somewhere harmless without branching. It is never handed out, never cached
and never read as live context.

Prefix caching (vLLM-style, over FULL blocks only):

  * every block is refcounted; a block may appear in several sequences'
    tables at once (shared prompt prefix);
  * a prompt is chain-hashed per full block (blake2b over the previous
    block's digest + this block's token ids), so a block's key identifies
    the whole prefix up to and including it;
  * `register_prefix` publishes a finished prefill's full prompt blocks;
    `reserve_prefix` returns a table whose head is the shared cached blocks,
    and the engine prefills only the unmatched suffix;
  * a hashed block whose refcount drops to zero parks in an LRU pool of
    evictable cached blocks, still matchable; capacity pressure reclaims
    from the LRU tail only after the free list is empty;
  * full blocks are immutable; the one exception, a prompt that is ENTIRELY
    cached (its re-decoded last token would land in the final shared
    block), is handled by copy-on-write: `reserve_prefix` forks that block.

Speculative decoding accounts its verify windows here: `append_token`
grows the live length one token at a time (copy-on-write forking a shared
or published destination block, recorded in `last_fork`), and `rollback`
rewinds a rejected tail exactly, never below the admission reservation
(`_base`, the table length `allocate`, `reserve` and `reserve_prefix`
claimed).

KV-block streaming (disaggregated prefill, live migration): `export_prefix`
lists the resident full-block prefix of a token sequence with its chain
digests, and `import_block` admits one streamed block after recomputing
its digest from the previous link and the claimed tokens.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..observability.registry import counter as _counter, gauge as _gauge

_BLOCKS_TOTAL = _gauge("serving_kv_blocks_total",
                       "KV pool size in blocks (excl. the null block).",
                       always=True)
_BLOCKS_USED = _gauge("serving_kv_blocks_used",
                      "KV blocks currently assigned to sequences.",
                      always=True)
_BLOCKS_FREE = _gauge("serving_kv_blocks_free", "KV blocks on the free list.",
                      always=True)
_BLOCKS_CACHED = _gauge("serving_kv_cached_blocks",
                        "Evictable prefix-cache blocks (hashed, refcount 0).",
                        always=True)
_TOKENS = _gauge("serving_kv_tokens", "Live KV tokens across all sequences.",
                 always=True)
_OCCUPANCY = _gauge("serving_kv_occupancy", "used / allocatable KV blocks.",
                    always=True)
_FRAG = _gauge("serving_kv_fragmentation",
               "1 - tokens/(used*block_size): tail waste of partially "
               "filled last blocks.", always=True)
_PREFIX_HITS = _counter("serving_prefix_cache_hits_total",
                        "Admissions that matched >=1 cached prefix block.",
                        always=True)
_PREFIX_MISSES = _counter("serving_prefix_cache_misses_total",
                          "Admissions that matched no cached block.",
                          always=True)
_PREFIX_HIT_TOKENS = _counter("serving_prefix_hit_tokens_total",
                              "Prompt tokens served from the prefix cache "
                              "(prefill skipped).", always=True)
_PREFIX_EVICTIONS = _counter("serving_prefix_evictions_total",
                             "Cached blocks reclaimed under capacity "
                             "pressure.", always=True)
_PREFIX_DEDUPS = _counter("serving_prefix_dedup_blocks_total",
                          "Private prefilled blocks swapped for an "
                          "already-indexed twin at register time.",
                          always=True)


_PREFIX_IMPORTS = _counter("serving_prefix_imported_blocks_total",
                           "Streamed KV blocks admitted into the cache "
                           "after chain-hash verification.", always=True)
_PREFIX_IMPORT_DEDUPS = _counter("serving_prefix_import_dedup_total",
                                 "Streamed blocks whose digest was already "
                                 "resident (idempotent no-op).", always=True)


class BlockAllocator:
    """Host-side allocator over a pool of `num_blocks` blocks of
    `block_size` tokens each. Block ids index the device pool directly."""

    NULL_BLOCK = 0

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        # stack: LIFO reuse; block 0 reserved (never handed out)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lens: Dict[object, int] = {}
        # refcounts for LIVE blocks only (block in >=1 table or pinned)
        self._ref: Dict[int, int] = {}
        # content addressing: block -> chain digest, digest -> block
        self._digest: Dict[int, bytes] = {}
        self._index: Dict[bytes, int] = {}
        # refcount-0 hashed blocks, LRU order (oldest first = evict first)
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        # copy-on-write source pins: seq_id -> blocks held alive beyond the
        # table so the engine can copy them before any eviction
        self._extra: Dict[object, List[int]] = {}
        self._tokens = 0            # running sum of _lens (O(1) publish)
        # register_prefix dedup swaps: [(table_index, private, canonical)]
        self.last_dedup: List[Tuple[int, int, int]] = []
        # reservation floor per sequence: the table length claimed at
        # admission, which rollback never trims below
        self._base: Dict[object, int] = {}
        # copy-on-write fork of the last append_token: (src, dst) or None
        self.last_fork: Optional[Tuple[int, int]] = None
        self._publish()

    # -- capacity ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        return len(self._evictable)

    @property
    def available_blocks(self) -> int:
        """Blocks a new reservation can claim: free + evictable cached."""
        return len(self._free) + len(self._evictable)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)  # ceil div

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.available_blocks

    # -- content addressing -----------------------------------------------
    def chain_digest(self, prev: bytes, tokens) -> bytes:
        """One link of the chain hash: commits to `prev` (the previous full
        block's digest, b"" at the chain head) plus this block's ids."""
        h = hashlib.blake2b(prev, digest_size=16)
        for t in tokens:
            h.update(int(t).to_bytes(8, "little", signed=True))
        return h.digest()

    def block_hashes(self, tokens) -> List[bytes]:
        """Chain digests for every FULL block of `tokens`."""
        out: List[bytes] = []
        prev = b""
        bs = self.block_size
        for i in range(len(tokens) // bs):
            prev = self.chain_digest(prev, tokens[i * bs:(i + 1) * bs])
            out.append(prev)
        return out

    # -- KV-block streaming ------------------------------------------------
    def export_prefix(self, tokens) -> List[dict]:
        """Wire metadata for the resident full-block prefix of `tokens`: one
        record per indexed full block, chain order, stopping at the first
        full block not in the index; each carries the chain digest, the
        previous link's digest, the block's token ids and the local block
        id (where the caller reads the block's KV). Read-only."""
        out: List[dict] = []
        prev = b""
        bs = self.block_size
        for i in range(len(tokens) // bs):
            blk_tokens = [int(t) for t in tokens[i * bs:(i + 1) * bs]]
            key = self.chain_digest(prev, blk_tokens)
            blk = self._index.get(key)
            if blk is None:
                break
            out.append({"digest": key, "prev": prev, "block": blk,
                        "tokens": blk_tokens})
            prev = key
        return out

    def import_block(self, prev_digest: bytes, tokens,
                     digest: bytes) -> Tuple[int, bool]:
        """Admit one streamed full block into the cache. The digest is
        recomputed from `prev_digest` + `tokens` and must equal `digest`
        (ValueError otherwise, before anything moves). Returns
        `(block_id, imported)`: an already-resident digest gives
        `(existing, False)` and refreshes its LRU place; otherwise a blank
        block (free stack, then LRU eviction) is published straight into
        the evictable cached pool (refcount 0, matchable), and the caller
        writes the block's KV into the pool at `block_id` before any
        reservation can match it. Raises MemoryError when no blank block
        exists."""
        if not self.prefix_cache:
            raise ValueError("prefix cache disabled: an imported block "
                             "could never be matched")
        if len(tokens) != self.block_size:
            raise ValueError(f"imported block carries {len(tokens)} tokens, "
                             f"expected a full block of {self.block_size}")
        want = self.chain_digest(prev_digest, tokens)
        if want != bytes(digest):
            raise ValueError("chain-hash mismatch: streamed block rejected "
                             "(corrupt payload or broken chain)")
        blk = self._index.get(want)
        if blk is not None:
            if blk in self._evictable:
                self._evictable.move_to_end(blk)
            _PREFIX_IMPORT_DEDUPS.inc()
            return blk, False
        blk = self._pop_block()
        self._digest[blk] = want
        self._index[want] = blk
        self._evictable[blk] = None      # newest at the LRU tail
        _PREFIX_IMPORTS.inc()
        self._publish()
        return blk, True

    def peek_match(self, tokens) -> int:
        """Prompt tokens a reservation would serve from the cache (no side
        effects)."""
        return min(len(self._match(tokens)) * self.block_size, len(tokens))

    def blocks_needed(self, tokens, total_tokens: int) -> int:
        """New blocks a reserve_prefix() would claim (the suffix's worst
        case, +1 when a full-prompt match forks its last block); revived
        cached blocks are not counted."""
        plen = len(tokens)
        m = len(self._match(tokens))
        need = self.blocks_for(max(int(total_tokens), plen, 1)) - m
        if m and m * self.block_size >= plen:
            need += 1
        return need

    def _match(self, tokens) -> List[int]:
        """Longest run of cached blocks covering a prefix of `tokens`."""
        if not self.prefix_cache:
            return []
        matched: List[int] = []
        for key in self.block_hashes(tokens):
            blk = self._index.get(key)
            if blk is None:
                break
            matched.append(blk)
        return matched

    def can_reserve_prefix(self, tokens, total_tokens: int) -> bool:
        """Admission gate: do the suffix's new blocks fit beside the matched
        blocks that must be revived out of the evictable pool?"""
        revive = sum(1 for b in self._match(tokens) if b in self._evictable)
        return (self.blocks_needed(tokens, total_tokens) + revive
                <= self.available_blocks)

    # -- block pool internals ---------------------------------------------
    def _pop_block(self) -> int:
        """A blank block: the free stack first, then evict the LRU cached
        block (dropping its index entry)."""
        if self._free:
            return self._free.pop()
        if self._evictable:
            blk, _ = self._evictable.popitem(last=False)   # oldest first
            key = self._digest.pop(blk)
            del self._index[key]
            _PREFIX_EVICTIONS.inc()
            return blk
        raise MemoryError("KV pool exhausted")

    def _claim(self, need: int) -> List[int]:
        if need > self.available_blocks:
            raise MemoryError(
                f"KV pool exhausted: need {need} blocks, "
                f"{self.available_blocks} available")
        out = []
        for _ in range(need):
            blk = self._pop_block()
            self._ref[blk] = 1
            out.append(blk)
        return out

    def _decref(self, blk: int) -> bool:
        """Drop one reference; True when the block left the live set."""
        n = self._ref[blk] - 1
        if n > 0:
            self._ref[blk] = n
            return False
        del self._ref[blk]
        if blk in self._digest and self.prefix_cache:
            self._evictable[blk] = None          # newest at the LRU tail
        else:
            self._free.append(blk)
        return True

    def _revive(self, blk: int) -> None:
        """Take a matched block live (cached -> referenced, or +1 ref)."""
        if blk in self._ref:
            self._ref[blk] += 1
        else:
            del self._evictable[blk]
            self._ref[blk] = 1

    # -- lifecycle --------------------------------------------------------
    def allocate(self, seq_id, n_tokens: int) -> List[int]:
        """Claim blocks for a new sequence of `n_tokens`. Returns the block
        table. Raises KeyError on a duplicate id, MemoryError when the pool
        cannot hold it."""
        return self.reserve(seq_id, n_tokens, n_tokens)

    def reserve(self, seq_id, n_tokens: int, total_tokens: int) -> List[int]:
        """allocate(), but claim blocks for `total_tokens` (the worst case)
        up front while the live length starts at `n_tokens`, so the table
        never grows mid-decode."""
        if seq_id in self._tables:
            raise KeyError(f"sequence {seq_id!r} already allocated")
        need = self.blocks_for(max(int(total_tokens), int(n_tokens), 1))
        table = self._claim(need)
        self._tables[seq_id] = table
        self._lens[seq_id] = int(n_tokens)
        self._tokens += int(n_tokens)
        self._base[seq_id] = len(table)
        self._publish()
        return table

    def reserve_prefix(self, seq_id, tokens,
                       total_tokens: int) -> Tuple[List[int], int,
                                                   Optional[int], int]:
        """Claim the worst-case table for a new sequence (`total_tokens`),
        its head reusing cached blocks that match the prompt's full-block
        prefix. Returns `(table, matched_tokens, cow_src, new_blocks)`:

          * `matched_tokens`: prompt tokens whose KV is already resident;
          * `cow_src`: when the ENTIRE prompt matched, the shared source of
            the forked last block (pinned until free(seq_id));
          * `new_blocks`: blocks claimed from the pool.
        """
        if seq_id in self._tables:
            raise KeyError(f"sequence {seq_id!r} already allocated")
        plen = len(tokens)
        matched = self._match(tokens)
        m = len(matched)
        total = self.blocks_for(max(int(total_tokens), plen, 1))
        full_match = bool(m) and m * self.block_size >= plen
        need = total - m + (1 if full_match else 0)
        revive = sum(1 for b in matched if b in self._evictable)
        if need + revive > self.available_blocks:
            raise MemoryError(
                f"KV pool exhausted: need {need} blocks beside {revive} "
                f"revivals, {self.available_blocks} available")
        # revive FIRST: _pop_block must never evict a block we matched
        for blk in matched:
            self._revive(blk)
        fresh = self._claim(need)
        cow_src: Optional[int] = None
        if full_match:
            cow_src = matched[-1]
            table = matched[:-1] + [fresh[0]] + fresh[1:]
            self._extra.setdefault(seq_id, []).append(cow_src)
        else:
            table = matched + fresh
        self._tables[seq_id] = table
        self._lens[seq_id] = plen
        self._tokens += plen
        self._base[seq_id] = len(table)
        matched_tokens = min(m * self.block_size, plen)
        if m:
            _PREFIX_HITS.inc()
            _PREFIX_HIT_TOKENS.inc(matched_tokens)
        elif self.prefix_cache:
            _PREFIX_MISSES.inc()
        self._publish()
        return table, matched_tokens, cow_src, need

    def register_prefix(self, seq_id, tokens) -> int:
        """Publish a prefilled prompt's full blocks into the hash index.
        Call AFTER the prefix KV is in the pool pages. Idempotent. A block
        whose key is already indexed under another block (two identical
        prompts prefilled concurrently) is swapped for the canonical one
        (live dedup), recorded in `last_dedup` as (table_index, private,
        canonical) so the caller can redirect its block-table row. Returns
        how many blocks were newly indexed."""
        if not self.prefix_cache:
            return 0
        table = self._tables[seq_id]
        added = 0
        self.last_dedup = []
        for i, key in enumerate(self.block_hashes(tokens)):
            blk = table[i]
            if blk == self.NULL_BLOCK or blk in self._digest:
                continue
            canon = self._index.get(key)
            if canon is not None and canon != blk:
                self._revive(canon)
                table[i] = canon
                self._decref(blk)
                self.last_dedup.append((i, blk, canon))
                _PREFIX_DEDUPS.inc()
                continue
            self._digest[blk] = key
            self._index[key] = blk
            added += 1
        if self.last_dedup:
            self._publish()
        return added

    def rollback(self, seq_id, n_tokens: int) -> List[int]:
        """Rewind a sequence by `n_tokens` (a rejected speculative tail):
        the live length shrinks, and blocks appended past the admission
        reservation that the shorter length no longer needs are released;
        the reservation itself is never trimmed. Returns the table. The
        rejected tail's device KV stays in place, masked by the length: it
        only ever landed in this sequence's private blocks."""
        n = int(n_tokens)
        if n < 0:
            raise ValueError("rollback count must be >= 0")
        if n == 0:
            return self._tables[seq_id]
        if n > self._lens[seq_id]:
            raise ValueError(
                f"rollback of {n} exceeds live length {self._lens[seq_id]}")
        table = self._tables[seq_id]
        new_len = self._lens[seq_id] - n
        keep = max(self.blocks_for(max(new_len, 1)),
                   self._base.get(seq_id, 0))
        while len(table) > keep:
            self._decref(table.pop())
        self._lens[seq_id] = new_len
        self._tokens -= n
        self._publish()
        return table

    def append_token(self, seq_id) -> List[int]:
        """Account one decoded token: the table grows by a block when the
        sequence crosses a block boundary, and the destination block is
        copy-on-write forked when it is shared (refcount > 1) or published
        in the prefix index, recorded as `last_fork = (src, dst)` for the
        caller that owns the device copy. Raises MemoryError when a needed
        block is not there."""
        table = self._tables[seq_id]
        n = self._lens[seq_id] + 1
        self.last_fork = None
        if self.blocks_for(n) > len(table):
            if not self.available_blocks:
                raise MemoryError("KV pool exhausted on append")
            blk = self._pop_block()
            self._ref[blk] = 1
            table.append(blk)
        else:
            bi = (n - 1) // self.block_size   # block receiving this token
            blk = table[bi]
            if self._ref.get(blk, 0) > 1 or blk in self._digest:
                dst = self._pop_block()
                self._ref[dst] = 1
                table[bi] = dst
                self._decref(blk)
                self.last_fork = (blk, dst)
        self._lens[seq_id] = n
        self._tokens += 1
        self._publish()
        return table

    def free(self, seq_id) -> int:
        """Release a sequence's references: unhashed blocks go back to the
        free stack, hashed ones park in the evictable LRU pool. Returns how
        many blocks left the live set."""
        table = self._tables.pop(seq_id)
        self._tokens -= self._lens.pop(seq_id)
        self._base.pop(seq_id, None)
        released = 0
        for blk in reversed(table):      # LIFO: reuse hottest first
            released += self._decref(blk)
        for blk in self._extra.pop(seq_id, ()):
            released += self._decref(blk)
        self._publish()
        return released

    # -- introspection ----------------------------------------------------
    def table(self, seq_id) -> List[int]:
        return list(self._tables[seq_id])

    def seq_len(self, seq_id) -> int:
        return self._lens[seq_id]

    def refcount(self, blk: int) -> int:
        return self._ref.get(blk, 0)

    def sequences(self):
        return list(self._tables)

    def check_invariants(self) -> None:
        """Conservation + sharing invariants (raises AssertionError)."""
        allocatable = self.num_blocks - 1
        live = set(self._ref)
        ev = set(self._evictable)
        free = set(self._free)
        if (live & ev) or (live & free) or (ev & free):
            raise AssertionError("a block is in two pools at once")
        if len(live) + len(ev) + len(free) != allocatable:
            raise AssertionError(
                f"conservation violated: {len(live)}+{len(ev)}+{len(free)} "
                f"!= {allocatable}")
        if self.NULL_BLOCK in live | ev | free or \
                self.NULL_BLOCK in self._digest:
            raise AssertionError("the null block left its reservation")
        readers: Dict[int, int] = {}
        for t in list(self._tables.values()) + list(self._extra.values()):
            for b in t:
                readers[b] = readers.get(b, 0) + 1
        for b, r in readers.items():
            if self._ref.get(b, 0) != r:
                raise AssertionError(
                    f"block {b}: refcount {self._ref.get(b, 0)} != {r} "
                    f"readers")
        if set(readers) != live:
            raise AssertionError("a live block has no reader")
        if {v: k for k, v in self._index.items()} != self._digest:
            raise AssertionError("index and digest maps disagree")
        if not ev <= set(self._digest):
            raise AssertionError("an evictable block is not hashed")
        if self._tokens != sum(self._lens.values()):
            raise AssertionError("token count drifted")
        for seq_id, floor in self._base.items():
            if seq_id not in self._tables:
                raise AssertionError(f"reservation floor of {seq_id!r} "
                                     f"outlived its table")
            if floor > len(self._tables[seq_id]):
                raise AssertionError(f"{seq_id!r}: table trimmed below its "
                                     f"reservation of {floor} blocks")

    def conservation_ok(self) -> bool:
        """O(1) conservation law: every allocatable block is in exactly one
        of live / evictable / free."""
        return (len(self._ref) + len(self._evictable) + len(self._free)
                == self.num_blocks - 1)

    def occupancy_report(self) -> dict:
        allocatable = self.num_blocks - 1
        used = self.used_blocks
        tokens = self._tokens
        cap = used * self.block_size
        return {
            "conservation_ok": self.conservation_ok(),
            "num_blocks": allocatable,
            "block_size": self.block_size,
            "used_blocks": used,
            "free_blocks": len(self._free),
            "cached_blocks": len(self._evictable),
            "sequences": len(self._tables),
            "tokens": tokens,
            "occupancy": used / allocatable if allocatable else 0.0,
            "fragmentation": max(0.0, 1.0 - tokens / cap) if cap else 0.0,
        }

    def _publish(self):
        allocatable = self.num_blocks - 1
        used = len(self._ref)
        cap = used * self.block_size
        _BLOCKS_TOTAL.set(allocatable)
        _BLOCKS_USED.set(used)
        _BLOCKS_FREE.set(len(self._free))
        _BLOCKS_CACHED.set(len(self._evictable))
        _TOKENS.set(self._tokens)
        _OCCUPANCY.set(used / allocatable if allocatable else 0.0)
        _FRAG.set(max(0.0, 1.0 - self._tokens / cap) if cap else 0.0)
