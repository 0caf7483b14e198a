"""GPT family (counterpart of paddle_tpu/models/gpt.py:33-378), the training
forward: pre-LN blocks, fused QKV projection, learned positions, GELU (tanh)
MLP and the head tied to the token embedding, with the shifted next-token
cross entropy when `labels` are given.

Attention goes through ops.nn_ops.scaled_dot_product_attention, so it takes
the flash kernels wherever the reference would take its Pallas ones. Packed
batches (`segments=` [b, s] document ids, padding -1; bench.py's
BENCH_PACKED path) restart the learned positions at every document, attend
within each document through ops.nn_ops.segmented_attention (the segmented
flash kernels) and mask the loss's pairs across documents. The KV-cache
(decode), `sequence_parallel`, `recompute` and rotary branches of the
reference raise NotImplementedError naming the ROADMAP item that brings
them.

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
from ..nn import (ColumnParallelLinear, Dropout, Embedding, LayerNorm,
                  RowParallelLinear, VocabParallelEmbedding)
from ..ops import nn_ops
from .generation import causal_lm_loss, packed_positions


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

    def forward(self, x, segments=None):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x)
        # [b, s, heads, 3 * head_dim], split on the LAST axis (gpt.py:93-94)
        qkv = qkv.reshape(b, s, self.num_heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
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

    def forward(self, x, segments=None):
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
        if config.recompute:
            raise _not_ported("recompute", "distributed and fleet")
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, **factory)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **factory)
        self.drop = Dropout(config.hidden_dropout_prob, generator=generator)
        self.blocks = nn.ModuleList([GPTBlock(config, generator, **factory)
                                     for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, **factory)

    def forward(self, input_ids, caches=None, pos=None, segments=None):
        if caches is not None:
            raise _not_ported("KV-cache decoding", "GPT serving")
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
            h = block(h, segments=segments)
        return self.ln_f(h)


class GPTForCausalLM(nn.Module):
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

    def _head(self, h):
        if self.lm_head is None:
            return nn_ops.matmul(h, self.gpt.wte.weight, transpose_y=True)
        return self.lm_head(h)

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                segments=None):
        """Logits [b, s, vocab]; with `labels`, the mean next-token cross
        entropy (logits[:, i] predicts labels[:, i + 1]; -100 is ignored,
        and with packed `segments` so is every pair that crosses a document
        boundary or ends in padding)."""
        logits = self._head(self.gpt(input_ids, caches=caches, pos=pos,
                                     segments=segments))
        if labels is None:
            return logits
        return causal_lm_loss(logits, labels, segments)
