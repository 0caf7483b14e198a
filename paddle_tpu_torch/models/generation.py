"""Autoregressive generation with static-shape KV caches (counterpart of
paddle_tpu/models/generation.py:33-194), and what the GPT and Llama
training forwards share: the per-document positions of packed rows
(`packed_positions`, generation.py:197) and the shifted loss that masks
pairs across documents (`causal_lm_loss`).

KV caches are [b, max_len, kv_heads, head_dim] tensors per layer, written in
place at `pos` by nn_ops.cached_multihead_attention. Prefill runs the whole
prompt at pos 0; each decode step feeds one token at its position. Sampling
(greedy / temperature / top-k / top-p) draws from a torch.Generator seeded
by `seed`; its numbers differ from the reference's jax.random draws, so
sampled outputs agree with the reference only in distribution.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.nn_ops import cross_entropy


def init_kv_cache(batch: int, max_len: int, num_layers: int,
                  num_kv_heads: int, head_dim: int, dtype=torch.float32,
                  device=None):
    """Allocate the per-layer static KV cache: list of (k, v) tensors."""
    shape = (batch, max_len, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def sample_logits(logits, do_sample: bool, temperature: float, top_k: int,
                  top_p: float, generator: Optional[torch.Generator]):
    """logits [b, vocab] -> ids [b] (int64). Greedy when not sampling or at
    temperature <= 0; otherwise temperature, top-k and nucleus (top-p:
    keep the smallest descending prefix whose mass reaches top_p, always at
    least the argmax) filters, then one categorical draw per row."""
    if not do_sample or (temperature is not None and temperature <= 0.0):
        return torch.argmax(logits, dim=-1)
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p and top_p < 1.0:
        sorted_l, order = torch.sort(logits, dim=-1, descending=True)
        sorted_p = torch.softmax(sorted_l, dim=-1)
        keep_sorted = (torch.cumsum(sorted_p, dim=-1) - sorted_p) < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def packed_positions(seg, s: int):
    """Per-document positions [b, s] int32 of a packed batch whose segment
    ids are seg [b, s]: positions restart at 0 wherever the id changes
    (shared by the GPT and Llama packed paths)."""
    b = seg.shape[0]
    ar = torch.arange(s, dtype=torch.int32, device=seg.device)[None]
    new_doc = torch.ones(b, s, dtype=torch.bool, device=seg.device)
    new_doc[:, 1:] = seg[:, 1:] != seg[:, :-1]
    starts = torch.cummax(torch.where(new_doc, ar, 0), dim=1).values
    return ar - starts


_MP_CACHE = ("KV-cache decoding under tensor parallelism (mp > 1) is not "
             "ported: the reference's serving engine has no mp path")


def mesh_mp_size() -> int:
    """The current mesh's mp axis size (1 without a mesh)."""
    from ..distributed.mesh import get_mesh

    mesh = get_mesh()
    return 1 if mesh is None else int(mesh.shape.get("mp", 1))


def check_tensor_parallel(config, n, dims) -> None:
    """Raise unless `n` mp ranks divide each of `dims` ({what: size}), and
    unless the config leaves sequence parallelism off (the sep x mp
    product is not ported)."""
    if n <= 1:
        return
    for what, size in dims.items():
        if size % n:
            raise ValueError(f"tensor parallelism: mp={n} does not divide "
                             f"{what} ({size})")
    if getattr(config, "sequence_parallel", None):
        raise NotImplementedError(
            "sequence_parallel with tensor parallelism (mp > 1): the sep x "
            "mp product is not ported (ROADMAP queue 1: sep x mp)")


def causal_lm_loss(logits, labels, segments=None, ignore_index=-100,
                   group=None):
    """The mean next-token cross entropy: logits[:, i] predicts
    labels[:, i + 1]. With packed `segments` [b, s], a pair that crosses a
    document boundary, or whose target is padding (-1), is not an example
    and is ignored (reference llama.py:294-308, gpt.py:368-375). With an
    mp `group`, `logits` are this rank's block of the vocabulary and the
    terms are ParallelCrossEntropy's over the group; the mean is over the
    count of targets, the same on every rank."""
    labels = labels[:, 1:]
    if segments is not None:
        seg = segments.to(labels.device)
        same_doc = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] >= 0)
        labels = torch.where(same_doc, labels,
                             torch.full_like(labels, ignore_index))
    flat = logits[:, :-1, :].reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1)
    if group is None:
        return cross_entropy(flat, labels, ignore_index=ignore_index)
    from ..distributed.fleet.mp_layers import parallel_cross_entropy

    terms = parallel_cross_entropy(flat, labels, group, ignore_index)
    count = (labels != ignore_index).sum()
    return terms.sum() / count.clamp(min=1).to(terms.dtype)


def pipeline_lm_loss(vocab_size: int, ignore_index=-100):
    """The loss of GPT's and Llama's pipeline_descs: causal_lm_loss of a
    microbatch's logits. Where the logits are this rank's block of the
    vocabulary (Llama's tied head over its vocabulary-parallel embedding
    at mp > 1), the terms are ParallelCrossEntropy's over the current
    mesh's mp group, as the model's own forward takes them: the loss of
    the whole vocabulary."""
    def loss(out, label):
        group = None
        if out.shape[-1] != vocab_size:
            from ..distributed.mesh import get_mesh

            group = get_mesh().group("mp")
        return causal_lm_loss(out, label, ignore_index=ignore_index,
                              group=group)
    return loss


class GenerationMixin:
    """Adds `generate()` to a causal LM whose forward supports
    `forward(input_ids, caches=..., pos=...) -> (logits, caches)` and that
    provides `_decode_geometry() -> (num_layers, num_kv_heads, head_dim,
    max_pos)` and a `device` property."""

    def _cache_dtype(self):
        return next(iter(self.parameters())).dtype

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0):
        """Greedy/sampled decoding. Returns the full sequence (prompt +
        generated) as an int32 tensor [b, s0 + n_new] on the model's device,
        where n_new is max_new_tokens capped at the context window
        (max_position_embeddings - prompt_len); the tail is cut early when
        every row has emitted eos_token_id."""
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
        b, s0 = ids.shape
        n_layers, n_kv, hd, max_pos = self._decode_geometry()
        max_len = min(int(max_pos), s0 + max_new_tokens)
        n_new = max_len - s0
        if n_new <= 0:
            raise ValueError(
                f"prompt length {s0} leaves no room under "
                f"max_position_embeddings={max_pos}")
        caches = init_kv_cache(b, max_len, n_layers, n_kv, hd,
                               self._cache_dtype(), dev)
        gen = (torch.Generator(device=dev).manual_seed(int(seed))
               if do_sample else None)
        cfg = (bool(do_sample), float(temperature), int(top_k), float(top_p),
               gen)

        logits, caches = self(ids, caches=caches, pos=0)
        tok = sample_logits(logits[:, -1, :], *cfg)
        out: List[torch.Tensor] = [tok]
        eos_rows = None
        if eos_token_id is not None:
            eos_rows = tok == eos_token_id
        for t in range(1, n_new):
            if eos_rows is not None and bool(eos_rows.all()):
                break
            logits, caches = self(tok[:, None], caches=caches,
                                  pos=s0 + t - 1)
            tok = sample_logits(logits[:, -1, :], *cfg)
            if eos_rows is not None:
                # rows already finished are padded with eos, not with the
                # model's continuation
                tok = torch.where(eos_rows, torch.full_like(
                    tok, eos_token_id), tok)
                eos_rows |= tok == eos_token_id
            out.append(tok)
        return torch.cat([ids] + [o[:, None] for o in out],
                         dim=1).to(torch.int32)
