"""Counterparts of the paddle_tpu/ops/kernels/nn_ops.py ops the port uses:
linear and matmul, dropout, GELU, LayerNorm, RMSNorm, cross
entropy, attention (flash or the reference's composition; dense, and
segmented over packed documents), RoPE (contiguous and per-token) and the
cache-carrying decode attentions.

The ops with a Hopper kernel (ops/gpu/) launch it for CUDA tensors and take
the kernel's plain version for CPU tensors; the rest are plain torch, as the
reference leaves them to XLA. Ops on the reference's amp lists cast their
inputs through `amp.cast_inputs`, as its dispatcher does. Index semantics
follow the reference's JAX ones where the serving engine relies on them:
scatters drop out-of-bounds rows, and dynamic slices clamp their start. KV
caches and pages are updated in place (JAX returns new arrays and donates
the old ones) and returned for the same call shape.
"""
from __future__ import annotations

import math

import torch

from ..amp.state import cast_inputs
from ..core.flags import get_flag
from .gpu import flash_attention as _flash
from .gpu.fused_norm import fused_rms_norm
from .gpu.paged_attention import paged_attention
from .gpu.rope import fused_rope, fused_rope_packed


# -------------------------------------------------------------------- dense
def linear(x, weight, bias=None):
    """nn_ops.linear:155: y = x @ W (+ b), W [in, out]."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def matmul(x, y, transpose_y=False):
    x, y = cast_inputs("matmul", x, y)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def dropout(x, p=0.5, training=True, generator=None):
    """nn_ops.dropout:176 (upscale_in_train) with the keep mask drawn from
    `generator` (the reference draws from its global key)."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def gelu(x, approximate=False):
    """nn_ops.gelu:42; approximate=True is the tanh form."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def cross_entropy(input, label, ignore_index=-100):
    """nn_ops.cross_entropy:591 for hard labels over the last axis, reduced
    by the mean: fp32 log-softmax (a black-list op), entries at
    ignore_index contribute 0 and the mean is over the valid labels (at
    least 1)."""
    (input,) = cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(input, dim=-1)
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """nn_ops.layer_norm:198: fp32 statistics, cast back to x's dtype, then
    the weight multiply and the bias add (a black-list op: under amp its
    inputs arrive in fp32). With float32 inputs the cast is a no-op and one
    ATen layer norm computes the same (it also saves less for backward)."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(normalized_shape)
    if all(t is None or t.dtype == torch.float32 for t in (x, weight, bias)):
        return torch.nn.functional.layer_norm(x, shape, weight, bias,
                                              epsilon)
    dims = tuple(range(x.dim() - len(shape), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


# ---------------------------------------------------------------------- norm
def rms_norm(x, weight=None, epsilon=1e-6):
    """nn_ops.rms_norm:215. A 1-D weight goes through the kernel (plain
    version on the CPU), as the reference sends it to the Pallas kernel."""
    x, weight = cast_inputs("rms_norm", x, weight)
    if weight is not None and weight.dim() == 1:
        return fused_rms_norm(x, weight, epsilon)
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                          + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    return y


# ----------------------------------------------------------------- attention
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, generator=None):
    """nn_ops.scaled_dot_product_attention:727 with its dispatch: the flash
    kernels (ops/gpu/flash_attention.py) when FLAGS_use_flash_attention is
    set and `supports()` admits the shapes (no mask, no dropout, sequences
    that the reference's 128-row blocks divide, d <= 256, no causal sq !=
    sk), otherwise the `_sdpa_xla` composition. Layout [b, s, h, d]."""
    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if get_flag("use_flash_attention") and _flash.supports(
            query.shape, key.shape, attn_mask,
            dropout_p if training else 0.0, is_causal):
        return _flash.flash_attention(query, key, value, scale, is_causal)
    return _sdpa_xla(query, key, value, attn_mask, dropout_p, is_causal,
                     training, scale, generator)


def segmented_attention(q, k, v, segment_ids, causal=True, scale=None):
    """nn_ops.segmented_attention:1210: packed-document attention, q, k, v
    [b, s, h, d] with segment_ids [b, s] (same id = same document; padding
    -1 matches only itself). The reference's gate sends it to the
    segmented flash kernels (FLAGS_use_flash_attention, s % 128 == 0,
    d <= 256); otherwise the dense block-diagonal mask goes through the
    `_sdpa_xla` composition, as the reference's fallback does."""
    q, k, v = cast_inputs("segmented_attention", q, k, v)
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    seg = segment_ids.to(device=q.device, dtype=torch.int32)
    if get_flag("use_flash_attention") and s % 128 == 0 and d <= 256:
        return _flash.flash_attention_segmented(q, k, v, seg, scale, causal)
    mask = seg[:, :, None] == seg[:, None, :]
    if causal:
        mask = mask & torch.ones(s, s, dtype=torch.bool,
                                 device=q.device).tril()[None]
    return _sdpa_xla(q, k, v, mask[:, None], 0.0, False, False, scale)


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, scale=None, dropout=0.0, causal=False):
    """nn_ops.flash_attn_unpadded:1140: varlen attention over sequences
    packed along the first axis, q [total_q, h, d], k, v [total_k, h, d],
    offsets cu_seqlens [n + 1]. The segmented flash kernels take it when the
    reference's gate admits it: the same offsets OBJECT for q and k
    (self-attention packing; equal values in another object could still
    mis-segment K), no dropout, total % 128 == 0, d <= 256. Otherwise a
    dense mask over the packed [total_q, total_k] scores (causal within each
    sequence by offsets) goes through the `_sdpa_xla` composition."""
    q, k, v = cast_inputs("flash_attn_unpadded", q, k, v)
    total, _, d = q.shape
    dev = q.device
    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=dev).long()
    pos_q = torch.arange(total, device=dev)
    pos_k = torch.arange(k.shape[0], device=dev)
    seg_q = torch.searchsorted(cu_q[1:], pos_q, right=True)
    seg_k = torch.searchsorted(cu_k[1:], pos_k, right=True)
    same_packing = (q.shape[0] == k.shape[0]
                    and cu_seqlens_q is cu_seqlens_k)
    if (get_flag("use_flash_attention") and same_packing and dropout == 0.0
            and total % 128 == 0 and d <= 256):
        out = _flash.flash_attention_segmented(
            q[None], k[None], v[None], seg_q[None].to(torch.int32), scale,
            causal)
        return out[0]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        off_q = pos_q - cu_q[seg_q]
        off_k = pos_k - cu_k[seg_k]
        mask = mask & (off_q[:, None] >= off_k[None, :])
    out = _sdpa_xla(q[None], k[None], v[None], mask[None, None], dropout,
                    False, dropout > 0, scale)
    return out[0]


def _sdpa_xla(query, key, value, attn_mask, dropout_p, is_causal, training,
              scale, generator=None):
    """nn_ops._sdpa_xla:776 in plain torch: logits in the input dtype, then
    fp32; masked entries take finfo(float32).min; the causal mask is aligned
    bottom-right; probabilities are cast to the query dtype before P.V, with
    dropout on them when training."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale).float()
    neg = torch.finfo(torch.float32).min
    if is_causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=query.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~mask, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, neg)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, generator=generator)
    return torch.matmul(probs, v).transpose(1, 2)


# ------------------------------------------------------------------- rope
def _seq_major(c):
    return c.dim() == 2 or (c.dim() == 4 and c.shape[0] == 1
                            and c.shape[2] == 1)


def rotary_position_embedding(q, k, cos, sin, rotate_half=True):
    """nn_ops.rotary_position_embedding:801. q, k [b, s, h, d]; cos, sin
    [s, d] or [1, s, 1, d] go through the kernel; other layouts take the
    `_rope_xla` composition."""
    fused_ok = (rotate_half and _seq_major(cos) and _seq_major(sin)
                and q.shape[1] == (cos.shape[1] if cos.dim() == 4
                                   else cos.shape[0]))
    if fused_ok:
        if cos.dim() == 4:
            cos = cos.reshape(cos.shape[1], cos.shape[3])
            sin = sin.reshape(sin.shape[1], sin.shape[3])
        return fused_rope(q, k, cos.float().contiguous(),
                          sin.float().contiguous())
    return _rope_xla(q, k, cos, sin, rotate_half)


def _rope_xla(q, k, cos, sin, rotate_half):
    """nn_ops._rope_xla:828, with its type promotion (an fp32 table makes
    the output fp32)."""
    def rot(x):
        if rotate_half:
            half = x.shape[-1] // 2
            return torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        x1 = x[..., 0::2]
        x2 = x[..., 1::2]
        return torch.stack([-x2, x1], dim=-1).reshape(x.shape)

    cos = cos[None, :, None, :] if cos.dim() == 2 else cos
    sin = sin[None, :, None, :] if sin.dim() == 2 else sin
    return q * cos + rot(q) * sin, k * cos + rot(k) * sin


def rotary_position_embedding_packed(q, k, cos, sin, pos):
    """nn_ops.rotary_position_embedding_packed:1191: q, k [b, s, h, d],
    cos/sin TABLES [P, d], per-token positions pos [b, s] (clamped to
    [0, P-1] as the TPU kernel clamps)."""
    return fused_rope_packed(q, k, cos.float().contiguous(),
                             sin.float().contiguous(),
                             pos.to(torch.int32).contiguous())


# ------------------------------------------------- cached decode attention
def cached_multihead_attention(q, k, v, k_cache, v_cache, pos, scale=None):
    """nn_ops.cached_multihead_attention:845. q [b, sq, hq, d]; k, v
    [b, sq, hkv, d]; caches [b, max_len, hkv, d], written IN PLACE.

    `pos` is a scalar (int or 0-d tensor: tokens already cached) or a
    per-row int vector [b] for ragged batched prefill. Scalar form: the new
    K/V land at [pos, pos+sq) with the start clamped to [0, max_len - sq]
    (lax.dynamic_update_slice), and query i sees keys <= pos + i (with the
    unclamped pos, as the reference masks). Vector form: row r's tokens land
    at pos[r] + i; writes past max_len are dropped (JAX scatter semantics)
    and row r's query i sees keys <= pos[r] + i.
    Returns (out [b, sq, hq, d], k_cache, v_cache)."""
    b, sq, hq, d = q.shape
    max_len, hkv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    ar_len = torch.arange(max_len, device=dev)
    ar_sq = torch.arange(sq, device=dev)
    if torch.is_tensor(pos) and pos.dim() == 1 and pos.shape[0] == b:
        idx = pos.to(device=dev, dtype=torch.int64)[:, None] + ar_sq[None]
        keep = (idx >= 0) & (idx < max_len)
        rows = torch.arange(b, device=dev)[:, None].expand(b, sq)
        k_cache[rows[keep], idx[keep]] = k[keep].to(k_cache.dtype)
        v_cache[rows[keep], idx[keep]] = v[keep].to(v_cache.dtype)
        attn_mask = (ar_len[None, None, :] <= idx[:, :, None])[:, None]
    else:
        p = int(pos)
        start = min(max(p, 0), max_len - sq)
        k_cache[:, start:start + sq] = k.to(k_cache.dtype)
        v_cache[:, start:start + sq] = v.to(v_cache.dtype)
        attn_mask = (ar_len[None, :] <= p + ar_sq[:, None])[None, None]
    k_all, v_all = k_cache, v_cache
    if hkv != hq:
        rep = hq // hkv
        k_all = k_all.repeat_interleave(rep, dim=2)
        v_all = v_all.repeat_interleave(rep, dim=2)
    out = scaled_dot_product_attention(q, k_all.to(q.dtype),
                                       v_all.to(q.dtype), attn_mask=attn_mask,
                                       scale=scale)
    return out, k_cache, v_cache


def paged_cached_attention(q, k, v, k_pages, v_pages, block_table, seq_lens,
                           scale=None):
    """nn_ops.paged_cached_attention:901, the single-token decode step:
    write each slot's new K/V at (block_table[seq // bs], seq % bs) IN
    PLACE, then attend each slot's query over its seq_lens + 1 tokens with
    the paged decode kernel. q [slots, 1, hq, d]; k, v [slots, 1, hkv, d];
    pages [num_blocks, block_size, hkv, d]; block_table [slots, max_blocks]
    int32; seq_lens [slots] int32. The block-table column is clamped to the
    table, as the reference's gather clamps. Idle slots (all-null tables,
    length 0) write and read the null block 0; their outputs are garbage
    the engine ignores. Returns (out [slots, 1, hq, d], k_pages, v_pages)."""
    slots, sq, hq, d = q.shape
    if sq != 1:
        raise NotImplementedError(
            "paged_cached_attention with a multi-token (speculative verify) "
            "window needs the verify kernel (paddle_tpu/ops/pallas/"
            "paged_attention.py _verify_kernel), which is not ported yet")
    bs = k_pages.shape[1]
    seq_lens = seq_lens.to(torch.int32)
    col = torch.clamp(seq_lens // bs, max=block_table.shape[1] - 1).long()
    page = block_table.gather(1, col[:, None])[:, 0].long()
    off = (seq_lens % bs).long()
    k_pages[page, off] = k[:, 0].to(k_pages.dtype)
    v_pages[page, off] = v[:, 0].to(v_pages.dtype)
    out = paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                          block_table, seq_lens + 1, scale)
    return out[:, None], k_pages, v_pages
