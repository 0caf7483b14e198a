"""Device-side paged KV pool + the cache view the models consume
(counterpart of paddle_tpu/serving/paged.py:27-85).

The pool is one preallocated tensor pair per layer,

    k_pages, v_pages : [num_blocks, block_size, kv_heads, head_dim]

indexed by the block ids of blocks.BlockAllocator. Page tensors are updated
IN PLACE (the decode step's KV append, the prefix scatter, copy-on-write
forks): this replaces JAX's buffer donation, so the pool never moves and is
never reallocated.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


class PagedLayerCache:
    """Per-layer paged-KV view: pages + the batch's block tables/lengths.
    The models duck-type on `.block_table` to take the paged decode path.

    seq_lens counts tokens ALREADY in the cache for each slot (the new
    token of the current decode step is written at position seq_lens and
    included in attention by the op)."""

    __slots__ = ("k_pages", "v_pages", "block_table", "seq_lens")

    def __init__(self, k_pages, v_pages, block_table, seq_lens):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.block_table = block_table
        self.seq_lens = seq_lens


class PagedKVPool:
    """Owns the per-layer page tensors."""

    def __init__(self, num_blocks: int, block_size: int, num_layers: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device=None):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        shape = (self.num_blocks, self.block_size, self.num_kv_heads,
                 self.head_dim)
        self.layers: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(self.num_layers)]

    def nbytes(self) -> int:
        k, _ = self.layers[0]
        return 2 * self.num_layers * k.numel() * k.element_size()


def write_prefix(k_pages, v_pages, k, v, table, *, block_size):
    """Scatter a contiguous KV prefix into its pages, in place.

    k, v: [plen_padded, kv_heads, d] with plen_padded a multiple of
    block_size; table: [plen_padded // block_size] block ids. Rows past the
    real prompt length land in the tail of the last block, masked by the
    context length until decode steps overwrite them."""
    nb = table.shape[0]
    k_pages[table] = k.reshape(nb, block_size, *k.shape[1:]).to(k_pages.dtype)
    v_pages[table] = v.reshape(nb, block_size, *v.shape[1:]).to(v_pages.dtype)
    return k_pages, v_pages
