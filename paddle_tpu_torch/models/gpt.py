"""GPT family (counterpart of paddle_tpu/models/gpt.py:33-378): pre-LN
blocks, fused QKV projection, learned positions, GELU (tanh) MLP and the
head tied to the token embedding, with the shifted next-token cross entropy
when `labels` are given, and the reference's cached forwards for generation
and serving (gpt.py:217-286):

  * contiguous cache, scalar `pos`: prefill and static-cache decode (a 0-d
    device `pos` is never read on the host, so a prefill chunk can be
    captured into a CUDA graph);
  * contiguous cache, per-row `pos` vector [b]: ragged batched prefill;
  * paged caches (serving.paged.PagedLayerCache): the engine's decode step
    and, with s > 1, the speculative verify window at positions
    seq_lens .. seq_lens + s - 1.

Learned positions past the `wpe` table (bucket padding of a batched
prefill, the padded tail of a verify window near max_model_len) are clamped
to its last row, as the port's per-token RoPE clamps: the reference's
`jnp.take` fills NaN there, and an index past the table would raise here.
Those positions belong to padding or rejected tokens, never to an answer.

Attention goes through ops.nn_ops.scaled_dot_product_attention, so it takes
the flash kernels wherever the reference would take its Pallas ones; the
cached forwards take the cached and paged attentions. Packed batches
(`segments=` [b, s] document ids, padding -1; bench.py's BENCH_PACKED path)
restart the learned positions at every document, attend within each
document through ops.nn_ops.segmented_attention (the segmented flash
kernels) and mask the loss's pairs across documents. With
`recompute=True` a training forward runs each block through
distributed.fleet.recompute (gpt.py:310-317), under `recompute_policy`:
the block's activations are recomputed in the backward pass. The
`sequence_parallel` and rotary branches of the reference raise
NotImplementedError naming the ROADMAP item that brings them.

Parameters are created on the target device and filled there from a seeded
torch.Generator (normal std `initializer_range`, LayerNorm weights at 1,
biases at 0), so a 1.3B model is never built on the host. Dropout draws its
masks from a second generator seeded from the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.dtype import convert_dtype
from ..core.place import resolve_device
from ..distributed.fleet.recompute import recompute
from ..nn import (ColumnParallelLinear, Dropout, Embedding, LayerNorm,
                  RowParallelLinear, VocabParallelEmbedding)
from ..ops import nn_ops
from .generation import GenerationMixin, causal_lm_loss, packed_positions


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 0  # 0 -> 4 * hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    use_rotary: bool = False
    tie_word_embeddings: bool = True
    recompute: bool = False
    recompute_policy: str = None
    sequence_parallel: str = None
    sep_axis: str = "sep"

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def gpt3_1p3b():
        """GPT-3 XL (1.3B): hidden 2048, 24 layers, 16 heads, 2048
        positions (the reference's preset)."""
        return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         max_position_embeddings=2048)

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                         num_heads=4, max_position_embeddings=256,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _not_ported(what, item):
    return NotImplementedError(
        f"GPT {what} is not ported yet (ROADMAP queue 1: {item})")


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPTConfig, generator=None, **factory):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.hidden_size = c.hidden_size
        self.qkv_proj = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                             **factory)
        self.out_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                          **factory)
        self.attn_dropout_p = c.attention_dropout_prob
        self.resid_dropout = Dropout(c.hidden_dropout_prob,
                                     generator=generator)
        self._generator = generator

    def forward(self, x, cache=None, pos=None, segments=None):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x)
        # [b, s, heads, 3 * head_dim], split on the LAST axis (gpt.py:93-94)
        qkv = qkv.reshape(b, s, self.num_heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        if cache is not None:
            if hasattr(cache, "block_table"):
                # paged (serving engine): per-slot lengths in the cache view
                out, new_k, new_v = nn_ops.paged_cached_attention(
                    q, k, v, cache.k_pages, cache.v_pages,
                    cache.block_table, cache.seq_lens)
            else:
                out, new_k, new_v = nn_ops.cached_multihead_attention(
                    q, k, v, cache[0], cache[1], pos)
            out = out.reshape(b, s, self.hidden_size)
            return self.resid_dropout(self.out_proj(out)), (new_k, new_v)
        if segments is not None:
            out = nn_ops.segmented_attention(q, k, v, segments, causal=True)
        else:
            out = nn_ops.scaled_dot_product_attention(
                q, k, v, is_causal=True,
                dropout_p=self.attn_dropout_p if self.training else 0.0,
                training=self.training, generator=self._generator)
        out = out.reshape(b, s, self.hidden_size)
        return self.resid_dropout(self.out_proj(out))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, generator=None, **factory):
        super().__init__()
        self.fc_in = ColumnParallelLinear(config.hidden_size,
                                          config.intermediate_size, **factory)
        self.fc_out = RowParallelLinear(config.intermediate_size,
                                        config.hidden_size, **factory)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, x):
        return self.dropout(self.fc_out(
            nn_ops.gelu(self.fc_in(x), approximate=True)))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, generator=None, **factory):
        super().__init__()
        self.ln_1 = LayerNorm(config.hidden_size, **factory)
        self.attn = CausalSelfAttention(config, generator, **factory)
        self.ln_2 = LayerNorm(config.hidden_size, **factory)
        self.mlp = GPTMLP(config, generator, **factory)

    def forward(self, x, cache=None, pos=None, segments=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln_1(x), cache=cache, pos=pos)
            x = x + a
            return x + self.mlp(self.ln_2(x)), new_cache
        x = x + self.attn(self.ln_1(x), segments=segments)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, generator=None, **factory):
        super().__init__()
        if config.use_rotary:
            raise _not_ported("with rotary positions", "GPT use_rotary")
        if config.sequence_parallel:
            raise _not_ported("sequence_parallel",
                              "distributed and fleet (context parallel)")
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, **factory)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **factory)
        self.drop = Dropout(config.hidden_dropout_prob, generator=generator)
        self.blocks = nn.ModuleList([GPTBlock(config, generator, **factory)
                                     for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, **factory)

    def _cached(self, input_ids, caches, pos):
        b, s = input_ids.shape
        ar = torch.arange(s, dtype=torch.int64, device=input_ids.device)
        if hasattr(caches[0], "block_table"):
            # paged: PER-SLOT positions seq_lens .. seq_lens + s - 1
            pos2d = caches[0].seq_lens.long()[:, None] + ar[None]
            layer_pos = None
        elif torch.is_tensor(pos) and pos.dim() == 1 and pos.shape[0] == b:
            # ragged batched prefill: each row at its own offset
            layer_pos = pos.to(device=input_ids.device, dtype=torch.int32)
            pos2d = layer_pos.long()[:, None] + ar[None]
        elif torch.is_tensor(pos):
            # 0-d device pos (a captured prefill chunk): never read on the
            # host
            layer_pos = pos
            pos2d = (ar + pos.to(device=input_ids.device,
                                 dtype=torch.int64))[None]
        else:
            layer_pos = int(pos)
            pos2d = (ar + layer_pos)[None]
        # learned positions clamped to the table (see the module note)
        pos2d = pos2d.clamp(0, self.config.max_position_embeddings - 1)
        h = self.drop(self.wte(input_ids) + self.wpe(pos2d))
        new_caches = []
        for block, cache in zip(self.blocks, caches):
            h, nc = block(h, cache=cache, pos=layer_pos)
            new_caches.append(nc)
        return self.ln_f(h), new_caches

    def forward(self, input_ids, caches=None, pos=None, segments=None):
        if caches is not None:
            if segments is not None:
                raise NotImplementedError(
                    "packed (segments=) batches are not supported with "
                    "KV-cache decoding")
            return self._cached(input_ids, caches, pos)
        s = input_ids.shape[1]
        if segments is not None:
            # positions restart at each packed document (gpt.py:287-300)
            segments = segments.to(device=input_ids.device,
                                   dtype=torch.int32)
            positions = packed_positions(segments, s)
        else:
            positions = torch.arange(s, device=input_ids.device)
        h = self.drop(self.wte(input_ids) + self.wpe(positions))
        for block in self.blocks:
            if self.config.recompute and self.training:
                h = recompute(block, h, segments=segments,
                              policy=self.config.recompute_policy)
            else:
                h = block(h, segments=segments)
        return self.ln_f(h)


class GPTForCausalLM(nn.Module, GenerationMixin):
    """`device=None` places the model on the current CUDA device (raising
    when there is none); `device="cpu"` runs the kernels' plain versions.
    `dtype` defaults to float32; `seed` seeds the weight init and, offset
    by one, the dropout masks."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        factory = {"device": dev, "dtype": convert_dtype(dtype)}
        gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
        self.gpt = GPTModel(config, gen, **factory)
        self.lm_head = (None if config.tie_word_embeddings else
                        ColumnParallelLinear(config.hidden_size,
                                             config.vocab_size,
                                             has_bias=False, **factory))
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if ".ln_" in name and name.endswith(".weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def _decode_geometry(self):
        c = self.config
        return (c.num_layers, c.num_heads, c.hidden_size // c.num_heads,
                c.max_position_embeddings)

    def _head(self, h):
        if self.lm_head is None:
            return nn_ops.matmul(h, self.gpt.wte.weight, transpose_y=True)
        return self.lm_head(h)

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                segments=None):
        """Logits [b, s, vocab]; with `caches`, (logits, new_caches); with
        `labels`, the mean next-token cross entropy (logits[:, i] predicts
        labels[:, i + 1]; -100 is ignored, and with packed `segments` so is
        every pair that crosses a document boundary or ends in padding)."""
        if caches is not None:
            h, new_caches = self.gpt(input_ids, caches=caches, pos=pos,
                                     segments=segments)
            return self._head(h), new_caches
        logits = self._head(self.gpt(input_ids, segments=segments))
        if labels is None:
            return logits
        return causal_lm_loss(logits, labels, segments)
