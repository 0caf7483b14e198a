"""GPT family (counterpart of paddle_tpu/models/gpt.py:33-378): pre-LN
blocks, fused QKV projection, learned positions (or, with `use_rotary`,
rotary ones: no `wpe`, q and k rotated by tables built once up to
max_position_embeddings, gpt.py:182-212), GELU (tanh) MLP and the
head tied to the token embedding, with the shifted next-token cross entropy
when `labels` are given, and the reference's cached forwards for generation
and serving (gpt.py:217-304):

  * contiguous cache, scalar `pos`: prefill and static-cache decode (a 0-d
    device `pos` is never read on the host, so a prefill chunk can be
    captured into a CUDA graph);
  * contiguous cache, per-row `pos` vector [b]: ragged batched prefill;
  * paged caches (serving.paged.PagedLayerCache): the engine's decode step
    and, with s > 1, the speculative verify window at positions
    seq_lens .. seq_lens + s - 1.

Rotary positions go through the RoPE kernel (ops/gpu/rope.py): contiguous
positions in the plain forward and at a host-int `pos`, per-token ones on
packed rows, at a 0-d device `pos`, per row and in the paged paths. As in
the reference, a scalar-`pos` window's table slice starts at pos clamped to
[0, max_position_embeddings - s] (lax.dynamic_slice).

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
the block's activations are recomputed in the backward pass.

`sequence_parallel` 'ring' or 'ulysses' (gpt.py:78-87,130-135) routes
attention through ops.nn_ops.sequence_parallel_attention over the
current mesh's `sep_axis` (distributed/context_parallel.py). The
reference computes on global arrays and shard-maps only the attention;
here every rank of the sep group takes the same call, `model(ids,
labels=ids)` with the global ids, and computes only its shard of the
sequence, s/n tokens, at positions offset by rank * s/n (learned and
rotary alike). The next-token shift is taken on the global labels, so a
shard's last token is labelled by the next shard's first; the loss is
the sum of the ranks' cross-entropy terms (an all-reduce whose backward
is the identity) over the count of the global labels. Without labels
the logits, and GPTModel's hidden states, are gathered to the whole
sequence; every rank computes the same from them, so the gather's
backward keeps this rank's slice of the cotangent
(`context_parallel.gather_replicated`). After `backward()` every rank
holds the gradients of the whole sequence: a `context_parallel.GradSum`
on the forward's output sums them over the group from the
post-accumulate hooks. (So a loss that also uses the model's parameters
outside its forward, a tied head applied to GPTModel's gathered states
by the caller, would have that use summed n times: GPTForCausalLM
applies its head to the shard, inside.) With no mesh, or a sep
axis of one rank, attention is the reference's dense composition on the
whole sequence. The reference's errors stand: attention dropout, a KV
cache or packed `segments=` under sequence parallelism raise.

Tensor parallelism (gpt.py:74-75, 149-150, 181: the reference's layers
are the mp layers, and GSPMD partitions them): under a mesh whose mp
axis has n > 1 ranks (or after distributed.shard_model_parameters), each
rank holds its block of qkv_proj's and fc_in's columns, of out_proj's
and fc_out's rows and of wte's vocabulary rows (distributed/fleet/
mp_layers.py), and runs the whole batch. The qkv projection is
head-major ([b, s, heads, 3 * head_dim], split on the last axis), so a
block of its columns holds whole heads' q, k and v: a rank attends with
num_heads / n heads. The tied head multiplies the hidden states (through
the copy region: their gradient is summed over the ranks) by wte's
block, giving this rank's block of the logits; with labels the shifted
loss is ParallelCrossEntropy's over the group, its mean over the global
count of targets; without labels the logits are gathered. wpe and the
LayerNorms stay whole (replicated). n must divide num_heads, the
intermediate size and the vocabulary; a KV cache, and sequence
parallelism with mp (the sep x mp product is a later slice), raise.

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
from ..distributed import context_parallel as _cp
from ..distributed.collective import (all_reduce_autograd,
                                      copy_to_model_parallel,
                                      gather_replicated_autograd)
from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding)
from ..distributed.fleet.recompute import recompute
from ..distributed.mesh import mp_group_of
from ..nn import Dropout, Embedding, LayerNorm
from ..nn.layers import init_normal_
from ..ops import nn_ops
from .generation import (_MP_CACHE, GenerationMixin, causal_lm_loss,
                         check_tensor_parallel, mesh_mp_size,
                         packed_positions, pipeline_lm_loss)
from .llama import _copy_pairs, _rope_tables


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


_SP_CACHE = ("KV-cache decoding under sequence_parallel is not "
             "supported; gather the sequence (sequence_parallel=None) for "
             "generation")
_SP_SEGMENTS = ("packed (segments=) batches are not supported under "
                "sequence_parallel; gather the sequence first")


def _gpt_dims(c):
    return {"num_heads": c.num_heads,
            "intermediate_size": c.intermediate_size,
            "vocab_size": c.vocab_size}


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPTConfig, generator=None, **factory):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.hidden_size = c.hidden_size
        self.qkv_proj = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                             gather_output=False, **factory)
        self.out_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                          input_is_parallel=True, **factory)
        self.attn_dropout_p = c.attention_dropout_prob
        self.resid_dropout = Dropout(c.hidden_dropout_prob,
                                     generator=generator)
        self._generator = generator
        self.sequence_parallel = c.sequence_parallel
        self.sep_axis = c.sep_axis
        if c.sequence_parallel and \
                c.sequence_parallel not in ("ring", "ulysses"):
            raise ValueError(
                f"GPTConfig.sequence_parallel must be None, 'ring' or "
                f"'ulysses', got {c.sequence_parallel!r}")
        if c.sequence_parallel and c.attention_dropout_prob:
            raise ValueError(
                "attention dropout is not supported under context "
                "parallelism (the ring/Ulysses kernels are deterministic); "
                "set attention_dropout_prob=0")

    def forward(self, x, rope=None, cache=None, pos=None, segments=None):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x)
        # [b, s, heads, 3 * head_dim], split on the LAST axis (gpt.py:93-94);
        # under tensor parallelism this rank's heads
        heads = qkv.shape[-1] // (3 * self.head_dim)
        qkv = qkv.reshape(b, s, heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        if rope is not None:
            if len(rope) == 3:  # per-token: (cos_table, sin_table, pos2d)
                q, k = nn_ops.rotary_position_embedding_packed(q, k, *rope)
            else:
                q, k = nn_ops.rotary_position_embedding(q, k, rope[0],
                                                        rope[1])
        if cache is not None:
            if hasattr(cache, "block_table"):
                # paged (serving engine): per-slot lengths in the cache view
                out, new_k, new_v = nn_ops.paged_cached_attention(
                    q, k, v, cache.k_pages, cache.v_pages,
                    cache.block_table, cache.seq_lens)
            else:
                out, new_k, new_v = nn_ops.cached_multihead_attention(
                    q, k, v, cache[0], cache[1], pos)
            out = out.reshape(b, s, heads * self.head_dim)
            return self.resid_dropout(self.out_proj(out)), (new_k, new_v)
        if segments is not None:
            out = nn_ops.segmented_attention(q, k, v, segments, causal=True)
        elif self.sequence_parallel:
            # this rank's shard of the sequence, over the sep group
            out = nn_ops.sequence_parallel_attention(
                q, k, v, axis_name=self.sep_axis,
                mode=self.sequence_parallel, causal=True)
        else:
            out = nn_ops.scaled_dot_product_attention(
                q, k, v, is_causal=True,
                dropout_p=self.attn_dropout_p if self.training else 0.0,
                training=self.training, generator=self._generator)
        out = out.reshape(b, s, heads * self.head_dim)
        return self.resid_dropout(self.out_proj(out))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, generator=None, **factory):
        super().__init__()
        self.fc_in = ColumnParallelLinear(config.hidden_size,
                                          config.intermediate_size,
                                          gather_output=False, **factory)
        self.fc_out = RowParallelLinear(config.intermediate_size,
                                        config.hidden_size,
                                        input_is_parallel=True, **factory)
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

    def forward(self, x, rope=None, cache=None, pos=None, segments=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln_1(x), rope=rope, cache=cache,
                                     pos=pos)
            x = x + a
            return x + self.mlp(self.ln_2(x)), new_cache
        x = x + self.attn(self.ln_1(x), rope=rope, segments=segments)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, generator=None, **factory):
        super().__init__()
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, **factory)
        if config.use_rotary:
            # fp32 tables, not parameters or buffers: a dtype cast of the
            # model leaves them (as the Llama's)
            self._rope = _rope_tables(
                config.hidden_size // config.num_heads,
                config.max_position_embeddings, 10000.0, factory["device"])
            self._rope_long = None
        else:
            self.wpe = Embedding(config.max_position_embeddings,
                                 config.hidden_size, **factory)
        self.drop = Dropout(config.hidden_dropout_prob, generator=generator)
        self.blocks = nn.ModuleList([GPTBlock(config, generator, **factory)
                                     for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, **factory)

    def _tables(self, n):
        """The rotary tables, at least n rows. `_rope` is never rebound:
        captured graphs read its storage. A plain forward past the
        positions gets a longer table of its own, as the reference's cache
        grows."""
        if self._rope[0].shape[0] >= n:
            return self._rope
        if self._rope_long is None or self._rope_long[0].shape[0] < n:
            self._rope_long = _rope_tables(
                self.config.hidden_size // self.config.num_heads, n, 10000.0,
                self._rope[0].device)
        return self._rope_long

    def _cached(self, input_ids, caches, pos):
        b, s = input_ids.shape
        ar = torch.arange(s, dtype=torch.int64, device=input_ids.device)
        rotary = self.config.use_rotary
        max_pos = self.config.max_position_embeddings
        rope = None
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
            p = pos.to(device=input_ids.device, dtype=torch.int64)
            if rotary:
                # the table slice at clamp(pos, 0, P - s), per token
                p = torch.clamp(p, 0, max_pos - s)
            pos2d = (ar + p)[None].expand(b, s)
        else:
            layer_pos = int(pos)
            if rotary:
                start = min(max(layer_pos, 0), max_pos - s)
                cos, sin = self._tables(max_pos)
                rope = (cos[start:start + s], sin[start:start + s])
            pos2d = (ar + layer_pos)[None]
        h = self.wte(input_ids)
        if rotary:
            if rope is None:
                cos, sin = self._tables(max_pos)
                rope = (cos[:max_pos], sin[:max_pos], pos2d.to(torch.int32))
        else:
            # learned positions clamped to the table (see the module note)
            h = h + self.wpe(pos2d.clamp(0, max_pos - 1))
        h = self.drop(h)
        new_caches = []
        for block, cache in zip(self.blocks, caches):
            h, nc = block(h, rope=rope, cache=cache, pos=layer_pos)
            new_caches.append(nc)
        return self.ln_f(h), new_caches

    @property
    def sequence_parallel_axis(self):
        """The mesh axis the sequence is sharded over, or None: jit.TrainStep
        reduces the gradients over it too."""
        c = self.config
        return c.sep_axis if c.sequence_parallel else None

    def zero_units(self):
        """ZeRO stage 3's units (distributed/sharding.py), in forward
        order: the embeddings, each block, the final norm."""
        emb = [self.wte] + ([self.wpe] if hasattr(self, "wpe") else [])
        return ([(emb, emb[0], emb[-1], ())]
                + [([b], b, b, ()) for b in self.blocks]
                + [([self.ln_f], self.ln_f, self.ln_f, ())])

    def _sp_group(self):
        """The sep group this model's sequence is sharded over, or None
        (not sequence-parallel, or no sep axis of more than one rank)."""
        if not self.config.sequence_parallel:
            return None
        return _cp.sep_group(self.config.sep_axis)

    def _sp_check(self, caches, segments):
        """The reference's refusals under sequence parallelism (its
        attention raises them; here before anything runs)."""
        if self.config.sequence_parallel:
            if caches is not None:
                raise NotImplementedError(_SP_CACHE)
            if segments is not None:
                raise NotImplementedError(_SP_SEGMENTS)

    def _sp_local(self, input_ids, group):
        """This rank's shard of the final hidden states [b, s/n, hidden]
        from the GLOBAL ids: tokens rank * s/n onwards, at those
        positions."""
        n, r = group.nranks, group.rank
        b, s = input_ids.shape
        if s % n:
            raise ValueError(f"sequence_parallel: sequence length {s} does "
                             f"not split into {n} ranks of "
                             f"{self.config.sep_axis!r}")
        m = s // n
        off = r * m
        ids = input_ids[:, off:off + m]
        h = self.wte(ids)
        rope = None
        if self.config.use_rotary:
            cos, sin = self._tables(s)
            rope = (cos[off:off + m], sin[off:off + m])
        else:
            h = h + self.wpe(torch.arange(off, off + m,
                                          device=input_ids.device))
        return self._blocks(self.drop(h), rope, None)

    def _blocks(self, h, rope, segments):
        for block in self.blocks:
            if self.config.recompute and self.training:
                h = recompute(block, h, rope=rope, segments=segments,
                              policy=self.config.recompute_policy)
            else:
                h = block(h, rope=rope, segments=segments)
        return self.ln_f(h)

    def _mp_check(self, caches):
        """The group wte is cut over (tensor parallelism), or None; checks
        the config against it and refuses a KV cache under it."""
        group = mp_group_of(self.wte.weight)
        if group is not None:
            check_tensor_parallel(self.config, group.nranks,
                                  _gpt_dims(self.config))
            if caches is not None:
                raise NotImplementedError(_MP_CACHE)
        return group

    def forward(self, input_ids, caches=None, pos=None, segments=None):
        self._sp_check(caches, segments)
        self._mp_check(caches)
        if caches is not None:
            if segments is not None:
                raise NotImplementedError(
                    "packed (segments=) batches are not supported with "
                    "KV-cache decoding")
            return self._cached(input_ids, caches, pos)
        group = self._sp_group()
        if group is not None:
            h = _cp.gather_replicated(self._sp_local(input_ids, group),
                                      group)
            return _cp.attach_grad_sum(self, group, h)
        s = input_ids.shape[1]
        if segments is not None:
            # positions restart at each packed document (gpt.py:287-300)
            segments = segments.to(device=input_ids.device,
                                   dtype=torch.int32)
            positions = packed_positions(segments, s)
        else:
            positions = torch.arange(s, device=input_ids.device)
        h = self.wte(input_ids)
        rope = None
        if self.config.use_rotary:
            cos, sin = self._tables(s)
            # tables sliced to s: positions are < s in both forms
            rope = (cos[:s], sin[:s])
            if segments is not None:
                rope = rope + (positions,)
        else:
            h = h + self.wpe(positions)
        return self._blocks(self.drop(h), rope, segments)


class GPTForCausalLM(nn.Module, GenerationMixin):
    """`device=None` places the model on the current CUDA device (raising
    when there is none); `device="cpu"` runs the kernels' plain versions.
    `dtype` defaults to float32; `seed` seeds the weight init and, offset
    by one, the dropout masks."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        check_tensor_parallel(config, mesh_mp_size(), _gpt_dims(config))
        dev = resolve_device(device)
        factory = {"device": dev, "dtype": convert_dtype(dtype)}
        gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
        self.gpt = GPTModel(config, gen, **factory)
        # untied: the logits stay this rank's block of the vocabulary
        self.lm_head = (None if config.tie_word_embeddings else
                        ColumnParallelLinear(config.hidden_size,
                                             config.vocab_size,
                                             has_bias=False,
                                             gather_output=False, **factory))
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
                init_normal_(p, std, gen)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def zero_units(self):
        """GPTModel's units, the final norm's with the head: the tied
        head gathers the embeddings (unit 0) again."""
        units = self.gpt.zero_units()
        norm = units.pop()[0]
        tied = self.lm_head is None
        return units + [(norm + ([] if tied else [self.lm_head]), norm[0],
                         self, (0,) if tied else ())]

    def _decode_geometry(self):
        c = self.config
        return (c.num_layers, c.num_heads, c.hidden_size // c.num_heads,
                c.max_position_embeddings)

    def _head(self, h):
        if self.lm_head is None:
            w = self.gpt.wte.weight
            h = copy_to_model_parallel(h, mp_group_of(w))
            return nn_ops.matmul(h, w, transpose_y=True)
        return self.lm_head(h)

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                segments=None):
        """Logits [b, s, vocab]; with `caches`, (logits, new_caches); with
        `labels`, the mean next-token cross entropy (logits[:, i] predicts
        labels[:, i + 1]; -100 is ignored, and with packed `segments` so is
        every pair that crosses a document boundary or ends in padding)."""
        mp = self.gpt._mp_check(caches)
        if caches is not None:
            h, new_caches = self.gpt(input_ids, caches=caches, pos=pos,
                                     segments=segments)
            return self._head(h), new_caches
        group = self.gpt._sp_group()
        if group is not None:
            self.gpt._sp_check(None, segments)
            logits = self._head(self.gpt._sp_local(input_ids, group))
            out = _cp.gather_replicated(logits, group) if labels is None \
                else self._sp_loss(logits, labels, group)
            return _cp.attach_grad_sum(self, group, out)
        logits = self._head(self.gpt(input_ids, segments=segments))
        if labels is None:
            return gather_replicated_autograd(logits, -1, mp)
        return causal_lm_loss(logits, labels, segments, group=mp)

    @staticmethod
    def _sp_loss(logits, labels, group, ignore_index=-100):
        """The mean next-token cross entropy of the whole sequence from
        this rank's logits [b, s/n, vocab] and the global labels: the
        shift is taken on the global labels, the terms are summed over the
        ranks and divided by the count of the global targets."""
        m = logits.shape[1]
        off = group.rank * m
        labels = labels.to(logits.device)
        target = labels[:, off + 1:off + m + 1]     # the last rank: m - 1
        total, _ = nn_ops.cross_entropy_sum(
            logits[:, :target.shape[1]].reshape(-1, logits.shape[-1]),
            target.reshape(-1), ignore_index)
        count = (labels[:, 1:] != ignore_index).sum()
        total = all_reduce_autograd(total, group)
        return total / count.clamp(min=1).to(total.dtype)


# --------------------------------------------------- pipeline decomposition
class _GPTPipeEmbed(nn.Module):
    """Stage-0 pre layer (gpt.py:382-411): token and learned positional
    embedding and dropout, and, tied, the final LayerNorm the head applies,
    so the pipeline's stages are GPTBlocks alone. Built on the host,
    uninitialised: `copy_weights` fills it. Its embeddings are whole at
    any mp degree, as the reference's plain nn.Embedding: the tied ends
    are replicated over the mp group."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.wte = Embedding(config.vocab_size, config.hidden_size)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size)
        self.drop = Dropout(config.hidden_dropout_prob)
        if config.tie_word_embeddings:
            self.ln_f = LayerNorm(config.hidden_size)

    @property
    def weight(self):
        return self.wte.weight

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.drop(self.wte(ids) + self.wpe(pos))


class _GPTPipeHead(nn.Module):
    """Untied head: the final norm and the projection (shared_post), its
    columns cut over the mp group and the logits gathered whole."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.ln_f = LayerNorm(config.hidden_size)
        self.proj = ColumnParallelLinear(config.hidden_size,
                                         config.vocab_size, has_bias=False,
                                         gather_output=True)

    @property
    def weight(self):
        return self.proj.weight

    def forward(self, h):
        return self.proj(self.ln_f(h))


def _gpt_tied_head_fwd(layer, h):
    return nn_ops.matmul(layer.ln_f(h), layer.wte.weight, transpose_y=True)


def _gpt_untied_head_fwd(layer, h):
    return layer(h)


def _gpt_pipeline_descs(self):
    """The LayerDesc decomposition for pipeline parallelism (gpt.py:
    443-499): [embedding] + [GPTBlock] * L + [tied or untied head].
    Returns (descs, loss_fn, copy_weights); copy_weights(pipeline_layer)
    copies this model's weights into the built PipelineLayer (each to the
    device its destination is on, and, at mp > 1, in its layout: a whole
    model's blocks into the cut layers, a cut model's embedding gathered
    into the whole pipe embedding), reverse=True back into the model.
    Rotary configs are refused: the rope tables are shared state the desc
    layers do not carry."""
    from ..distributed.fleet.pipeline_parallel import (LayerDesc,
                                                       SharedLayerDesc)

    cfg = self.config
    if cfg.use_rotary:
        raise ValueError("pipeline_descs: rotary GPT configs are not "
                         "pipeline-decomposable (rope is shared state)")
    descs = [SharedLayerDesc("embed", _GPTPipeEmbed, None, "weight", cfg)]
    descs += [LayerDesc(GPTBlock, cfg) for _ in range(cfg.num_layers)]
    if cfg.tie_word_embeddings:
        descs.append(SharedLayerDesc("embed", _GPTPipeEmbed,
                                     _gpt_tied_head_fwd, "weight", cfg))
    else:
        descs.append(SharedLayerDesc("head", _GPTPipeHead,
                                     _gpt_untied_head_fwd, "weight", cfg))
    model = self

    def copy_weights(pl, reverse=False):
        pre, gpt = pl.shared_pre, model.gpt
        pairs = [(gpt.wte.weight, pre.wte.weight),
                 (gpt.wpe.weight, pre.wpe.weight)]
        if cfg.tie_word_embeddings:
            pairs += [(gpt.ln_f.weight, pre.ln_f.weight),
                      (gpt.ln_f.bias, pre.ln_f.bias)]
        for src, dst in zip(gpt.blocks, pl.run_function):
            pairs += list(zip(src.parameters(), dst.parameters()))
        if not cfg.tie_word_embeddings:
            head = pl.shared_post[0]
            pairs += [(gpt.ln_f.weight, head.ln_f.weight),
                      (gpt.ln_f.bias, head.ln_f.bias),
                      (model.lm_head.weight, head.proj.weight)]
        _copy_pairs(pairs, reverse)

    return descs, pipeline_lm_loss(cfg.vocab_size), copy_weights


GPTForCausalLM.pipeline_descs = _gpt_pipeline_descs
