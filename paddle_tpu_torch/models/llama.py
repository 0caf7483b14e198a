"""LLaMA family (counterpart of paddle_tpu/models/llama.py).

Pre-norm RMSNorm + SwiGLU + rotary, grouped-query attention, with the
reference's forward modes (llama.py:182-256):

  * no cache: full-sequence causal attention, the training forward (the
    dense flash kernels), with `labels` the shifted next-token loss;
  * no cache, packed `segments=` [b, s] (document ids, padding -1):
    positions restart at every document (per-token RoPE), attention stays
    inside each document (the segmented flash kernels), and the loss masks
    pairs that cross a document boundary;
  * contiguous cache, scalar `pos`: chunked prefill and static-cache decode
    (a 0-d device `pos` rotates by per-token positions, the same values, so
    a prefill chunk can be captured into a CUDA graph);
  * contiguous cache, per-row `pos` vector [b]: ragged batched prefill;
  * paged caches (serving.paged.PagedLayerCache): the engine's decode step.

With `recompute=True` a training forward without a cache runs each decoder
layer through distributed.fleet.recompute (llama.py:248-255), under
`recompute_policy`.

Parameters are created on the target device and filled there from a seeded
torch.Generator (normal std `initializer_range`, norms at 1), so a 7B model
is never built on the host. The rope cos/sin tables are plain fp32 tensors
on the model's device, not buffers: `Module.to(dtype)` must not cast them
(the reference keeps them fp32 whatever the model dtype). Parameters are
trainable: RMSNorm, RoPE and attention have kernel backwards; generation
and the serving engine run under torch.no_grad().
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.dtype import convert_dtype
from ..core.place import resolve_device
from ..distributed.fleet.recompute import recompute
from ..nn import (ColumnParallelLinear, RMSNorm, RowParallelLinear,
                  VocabParallelEmbedding)
from ..ops import nn_ops
from .generation import GenerationMixin, causal_lm_loss, packed_positions


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_key_value_heads: int = 0  # 0 -> num_heads (MHA); < num_heads -> GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    recompute: bool = False
    recompute_policy: str = None

    def __post_init__(self):
        if not self.num_key_value_heads:
            self.num_key_value_heads = self.num_heads

    @staticmethod
    def llama2_7b():
        """meta-llama/Llama-2-7b-hf's published widths."""
        return LlamaConfig()

    @staticmethod
    def tiny():
        return LlamaConfig(vocab_size=512, hidden_size=128,
                           intermediate_size=256, num_layers=2, num_heads=4,
                           num_key_value_heads=2, max_position_embeddings=128)


def _rope_tables(head_dim, max_len, theta, device):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.q_proj = ColumnParallelLinear(
            c.hidden_size, c.num_heads * self.head_dim, has_bias=False,
            **factory)
        self.k_proj = ColumnParallelLinear(
            c.hidden_size, self.num_kv_heads * self.head_dim, has_bias=False,
            **factory)
        self.v_proj = ColumnParallelLinear(
            c.hidden_size, self.num_kv_heads * self.head_dim, has_bias=False,
            **factory)
        self.o_proj = RowParallelLinear(
            c.num_heads * self.head_dim, c.hidden_size, has_bias=False,
            **factory)

    def forward(self, x, rope, cache=None, pos=None, segments=None):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        if len(rope) == 3:  # per-token: (cos_table, sin_table, pos2d)
            q, k = nn_ops.rotary_position_embedding_packed(q, k, *rope)
        else:
            q, k = nn_ops.rotary_position_embedding(q, k, rope[0], rope[1])
        if cache is not None:
            if hasattr(cache, "block_table"):
                out, new_k, new_v = nn_ops.paged_cached_attention(
                    q, k, v, cache.k_pages, cache.v_pages,
                    cache.block_table, cache.seq_lens)
            else:
                out, new_k, new_v = nn_ops.cached_multihead_attention(
                    q, k, v, cache[0], cache[1], pos)
            out = out.reshape(b, s, self.num_heads * self.head_dim)
            return self.o_proj(out), (new_k, new_v)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if segments is not None:
            out = nn_ops.segmented_attention(q, k, v, segments, causal=True)
        else:
            out = nn_ops.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        c = config
        self.gate_proj = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, has_bias=False, **factory)
        self.up_proj = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, has_bias=False, **factory)
        self.down_proj = RowParallelLinear(
            c.intermediate_size, c.hidden_size, has_bias=False, **factory)

    def forward(self, x):
        return self.down_proj(
            nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **factory)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **factory)
        self.mlp = LlamaMLP(config, **factory)

    def forward(self, x, rope, cache=None, pos=None, segments=None):
        if cache is not None:
            a, new_cache = self.self_attn(self.input_layernorm(x), rope,
                                          cache=cache, pos=pos)
            x = x + a
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_cache
        x = x + self.self_attn(self.input_layernorm(x), rope,
                               segments=segments)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **factory)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **factory)
                                     for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **factory)
        head_dim = config.hidden_size // config.num_heads
        self._rope = _rope_tables(head_dim, config.max_position_embeddings,
                                  config.rope_theta, factory["device"])

    def _run(self, input_ids, rope, caches, pos):
        h = self.embed_tokens(input_ids)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            h, nc = layer(h, rope, cache=cache, pos=pos)
            new_caches.append(nc)
        return self.norm(h), new_caches

    def forward(self, input_ids, caches=None, pos=None, segments=None):
        b, s = input_ids.shape
        cos_t, sin_t = self._rope
        if caches is not None:
            if segments is not None:
                raise NotImplementedError(
                    "packed (segments=) batches are not supported with "
                    "KV-cache decoding")
            ar = torch.arange(s, dtype=torch.int32, device=input_ids.device)
            if hasattr(caches[0], "block_table"):
                # paged decode: per-slot positions via the per-token rope
                pos2d = caches[0].seq_lens.to(torch.int32)[:, None] + ar[None]
                return self._run(input_ids, (cos_t, sin_t, pos2d), caches,
                                 None)
            if torch.is_tensor(pos) and pos.dim() == 1 and pos.shape[0] == b:
                # ragged batched prefill: per-row offsets
                pos_v = pos.to(device=input_ids.device, dtype=torch.int32)
                pos2d = pos_v[:, None] + ar[None]
                return self._run(input_ids, (cos_t, sin_t, pos2d), caches,
                                 pos_v)
            if torch.is_tensor(pos):
                # 0-d device pos (a captured prefill chunk): the contiguous
                # slice's positions, clamp(pos, 0, P - s) + i, through the
                # per-token form, with no host read
                start = torch.clamp(pos.to(device=input_ids.device,
                                           dtype=torch.int32),
                                    0, cos_t.shape[0] - s)
                pos2d = (start + ar)[None].expand(b, s)
                return self._run(input_ids, (cos_t, sin_t, pos2d), caches,
                                 pos)
            # host-int pos: the table slice starts at pos clamped to
            # [0, P-s], as lax.dynamic_slice clamps (llama.py:221-225)
            p = int(pos)
            start = min(max(p, 0), cos_t.shape[0] - s)
            rope = (cos_t[start:start + s], sin_t[start:start + s])
            return self._run(input_ids, rope, caches, p)
        # tables sliced to s: positions are < s in both forms
        rope = (cos_t[:s], sin_t[:s])
        if segments is not None:
            segments = segments.to(device=input_ids.device,
                                   dtype=torch.int32)
            rope = rope + (packed_positions(segments, s),)
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            if self.config.recompute and self.training:
                h = recompute(layer, h, rope, segments=segments,
                              policy=self.config.recompute_policy)
            else:
                h = layer(h, rope, segments=segments)
        return self.norm(h)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """`device=None` places the model on the current CUDA device (raising
    when there is none); `device="cpu"` runs the kernels' plain versions.
    `dtype` defaults to float32; `seed` seeds the weight init."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        factory = {"device": resolve_device(device),
                   "dtype": convert_dtype(dtype)}
        self.model = LlamaModel(config, **factory)
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
            if name.endswith("layernorm.weight") or name == "model.norm.weight":
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def _decode_geometry(self):
        c = self.config
        return (c.num_layers, c.num_key_value_heads,
                c.hidden_size // c.num_heads, c.max_position_embeddings)

    def _head(self, h):
        if self.lm_head is None:
            return torch.matmul(h, self.model.embed_tokens.weight.t())
        return self.lm_head(h)

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                segments=None):
        """Logits [b, s, vocab]; with `caches`, (logits, new_caches); with
        `labels`, the mean next-token cross entropy (-100 is ignored, and
        with packed `segments` [b, s] so is every pair that crosses a
        document boundary or ends in padding)."""
        if caches is not None:
            h, new_caches = self.model(input_ids, caches=caches, pos=pos,
                                       segments=segments)
            return self._head(h), new_caches
        logits = self._head(self.model(input_ids, segments=segments))
        if labels is None:
            return logits
        return causal_lm_loss(logits, labels, segments)
