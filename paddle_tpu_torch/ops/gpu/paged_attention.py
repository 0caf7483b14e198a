"""Ragged paged attention, decode and the speculative verify window: the
CUDA kernels in csrc/paged_attention.cu and their plain PyTorch versions.

`paged_attention` replaces paddle_tpu/ops/pallas/paged_attention.py
`_decode_kernel` (via `_paged_pallas`); `paged_attention_multi` replaces
`_verify_kernel` (via `_paged_pallas_multi`). The source's header says what
bounds the kernels on the H100 (bytes: every live K/V row read once) and how
their design answers that. The plain versions are the counterparts of
`paged_attention_xla` and `paged_attention_xla_multi`, the reference's
dense-gather oracles.

    q            [slots, q_heads, d] (decode) or [slots, sq, q_heads, d]
    k/v_pages    [num_blocks, block_size, kv_heads, d]
    block_tables [slots, max_blocks] int32 page ids per slot (0 = null page)
    context_lens [slots] int32: decode, valid tokens including the current
                 one; verify, the tokens cached BEFORE the window (query i
                 sees positions < context_lens + i + 1)

GQA: kv head h serves q heads [h*g, (h+1)*g), g = q_heads // kv_heads.

Which kernel runs is chosen here, in `route`, from the shapes, dtype and
the tensors' addresses, before anything launches (no fallback), and passed
to the C entry points, which refuse a kernel the arguments do not fit. The
decode kernel holds up to MAX_G query rows a kv head and moves rows as
16-byte vectors; a decode step with a larger group, or whose rows or
tensors are not whole 16-byte vectors, runs the verify kernel as a window
of one token (counted on `paged_attention.launches` all the same). The
verify window runs the tensor-core kernel for bf16 with head_dim % 8 == 0
and 16-byte aligned q and pages (16 rows a block, four warps splitting the
context, P as two bf16 terms); fp32, fp16 and other bf16 shapes run the
CUDA-core one (8 rows a block), whose products stay fp32.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, _counts

NEG_INF = -1e30
MAX_G = 8           # query rows per kv head the decode kernel's block holds
ROW_TILE = 8        # (query, head) rows a CUDA-core verify block holds
MMA_ROW_TILE = 16   # (query, head) rows a tensor-core verify block holds
MAX_HEAD_DIM = 256  # the reference's supports() gate
# every dtype the reference's gates and amp's auto_cast admit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Split-count choice (choose_kv_splits). The decode kernel's 128-thread
# block holds 64 KB of shared memory (each warp's two-stage ring of K and V
# tiles) and 48-64 registers a thread at g = 1 (ptxas), so 3 blocks are
# resident on an SM; its four warps already split the block's run, so one
# block an SM keeps enough bytes in flight. Device times with the host's
# launches hidden (chip_smoke.py's decode_split_sweep, PERF.md section 7):
# at the serving slice's shape (8 slots x 32 kv heads, contexts 17-2048)
# one split ran fastest and 2-16 within 6%; with 2 slots 2-16 splits ran
# 0.030-0.033 ms against one split's 0.037. A split walks at least
# SPLIT_MIN_TOKENS of the table's span, two rounds of the four warps'
# 16-token tiles, so the combine stays small beside it.
BLOCKS_PER_SM = 1
SPLIT_MIN_TOKENS = 128
# The CUDA-core verify kernel's block (8 rows, <= 56 registers a thread,
# ~9.6 KB of shared memory) is resident about 9 times an SM: aim for 8.
CC_VERIFY_BLOCKS_PER_SM = 8
CC_VERIFY_SPLIT_MIN_TOKENS = 256
# The tensor-core verify kernel's block already splits its run four ways
# among its warps, so one block an SM keeps enough bytes in flight: at the
# speculative slice's shape (8 slots x 32 kv heads) one split ran fastest
# and every added split slower (chip_smoke.py's verify_split_sweep, PERF.md
# section 7). A split still walks at least 128 tokens, two tiles a warp.
VERIFY_BLOCKS_PER_SM = 1
VERIFY_SPLIT_MIN_TOKENS = 128


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens,
                          scale=None):
    """Dense gather of each slot's pages, mask past context_lens, fp32
    softmax; output in q's dtype. A slot with context 0 gets the softmax of
    an all-masked row (the mean of its gathered V), as the reference does."""
    slots, hq, d = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    max_ctx = block_tables.shape[1] * bs
    bt = block_tables.long()
    k = k_pages[bt].reshape(slots, max_ctx, hkv, d).float()
    v = v_pages[bt].reshape(slots, max_ctx, hkv, d).float()
    qg = q.reshape(slots, hkv, g, d).float()
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k) * scale
    live = (torch.arange(max_ctx, device=q.device)[None, :]
            < context_lens.to(torch.int64)[:, None])
    sc = torch.where(live[:, None, None, :], sc, torch.tensor(
        NEG_INF, dtype=sc.dtype, device=sc.device))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.to(q.dtype).reshape(slots, hq, d)


def paged_attention_multi_plain(q, k_pages, v_pages, block_tables,
                                context_lens, scale=None):
    """The verify window by dense gather: each slot's pages gathered whole,
    query i of a slot masked past context_lens + i + 1, fp32 softmax; output
    [slots, sq, q_heads, d] in q's dtype."""
    slots, sq, hq, d = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    max_ctx = block_tables.shape[1] * bs
    bt = block_tables.long()
    k = k_pages[bt].reshape(slots, max_ctx, hkv, d).float()
    v = v_pages[bt].reshape(slots, max_ctx, hkv, d).float()
    qg = q.reshape(slots, sq, hkv, g, d).transpose(1, 2).float()
    sc = torch.einsum("bhsgd,bkhd->bhsgk", qg, k) * scale
    dev = q.device
    live = (torch.arange(max_ctx, device=dev)[None, None, :]
            < (context_lens.to(torch.int64)[:, None, None]
               + torch.arange(sq, device=dev)[None, :, None] + 1))
    sc = torch.where(live[:, None, :, None, :], sc, torch.tensor(
        NEG_INF, dtype=sc.dtype, device=dev))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhsgk,bkhd->bhsgd", p, v)
    return out.to(q.dtype).transpose(1, 2).reshape(slots, sq, hq, d)


def _check(q, k_pages, v_pages, block_tables, context_lens, kv_splits):
    """Shapes, dtypes, devices and layout the kernels take: q [slots, hq, d]
    for decode or [slots, sq, hq, d] for the verify window, any group size
    g = hq / hkv (the reference's supports(): hq % hkv == 0, d <= 256)."""
    if q.dim() not in (3, 4) or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be "
                         f"[slots, q_heads, d] or [slots, sq, q_heads, d] "
                         f"and pages {tuple(k_pages.shape)} [blocks, "
                         f"block_size, kv_heads, d]")
    slots, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    nb, bs, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError("paged_attention: k/v pages and q disagree on shape")
    if hq % hkv or d > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernels take q_heads divisible by "
                         f"kv_heads and d <= {MAX_HEAD_DIM}; got "
                         f"q_heads={hq}, kv_heads={hkv}, d={d}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes float32, bfloat16 or "
                        f"float16 q and pages of one dtype; got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens must "
                        "be int32")
    if block_tables.shape[0] != slots or tuple(context_lens.shape) != (slots,):
        raise ValueError("paged_attention: block_tables/context_lens do not "
                         "match the slot count")
    if not 1 <= kv_splits <= block_tables.shape[1]:
        raise ValueError("more splits than pages")
    for t in (q, k_pages, v_pages, block_tables, context_lens):
        if t.device != q.device:
            raise ValueError("paged_attention: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("paged_attention kernel takes contiguous tensors")


def choose_kv_splits(slots, kv_heads, max_blocks, block_size, sm_count,
                     blocks_per_sm=BLOCKS_PER_SM,
                     min_tokens=SPLIT_MIN_TOKENS):
    """Split-K count for one step, from what the wrapper sees without
    reading the context lengths back to the host: enough (slot, kv_head,
    split) blocks to fill every SM `blocks_per_sm` deep, but no more splits
    than `min_tokens`-long runs fit in the table's span. The kernel cuts
    each slot's live context into that many equal runs. (The reference
    leaves the count to its autotuner, paged_attention_tuned.)"""
    fill = -(-blocks_per_sm * sm_count // (slots * kv_heads))
    span = max(1, max_blocks * block_size // min_tokens)
    return max(1, min(fill, span, max_blocks))


# The kernels `route` chooses (the C entry points' `kernel` argument)
DECODE, VERIFY_CUDA_CORES, VERIFY_TENSOR_CORES = 0, 1, 2


def route(q, k_pages, v_pages):
    """The kernel that runs q: a decode step [slots, hq, d] takes the
    decode kernel where g <= MAX_G, its rows are whole 16-byte vectors (d *
    itemsize % 16 == 0) and q and the pages are 16-byte aligned; every other
    decode step, and the verify window [slots, sq, hq, d], takes the verify
    kernel, on the tensor cores for bf16 with head_dim % 8 == 0 and aligned
    q and pages, else on the CUDA cores. Outputs are fresh allocations,
    aligned; the C entry points refuse a kernel whose needs the arguments
    do not meet."""
    d = q.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages))
    if (q.dim() == 3 and q.shape[1] // k_pages.shape[2] <= MAX_G
            and d * q.element_size() % 16 == 0 and aligned):
        return DECODE
    if q.dtype == torch.bfloat16 and d % 8 == 0 and aligned:
        return VERIFY_TENSOR_CORES
    return VERIFY_CUDA_CORES


def _splits(kernel, q, k_pages, block_tables, sm_count):
    """choose_kv_splits over the blocks of `kernel` with its residency:
    (slot, kv head) for the decode kernel, (slot, kv head, row tile) for
    the verify kernel, a decode step counting as a window of one."""
    slots, hq, hkv = q.shape[0], q.shape[-2], k_pages.shape[2]
    if kernel == DECODE:
        return choose_kv_splits(slots, hkv, block_tables.shape[1],
                                k_pages.shape[1], sm_count)
    if kernel == VERIFY_TENSOR_CORES:
        rows, per_sm, tokens = (MMA_ROW_TILE, VERIFY_BLOCKS_PER_SM,
                                VERIFY_SPLIT_MIN_TOKENS)
    else:
        rows, per_sm, tokens = (ROW_TILE, CC_VERIFY_BLOCKS_PER_SM,
                                CC_VERIFY_SPLIT_MIN_TOKENS)
    sq = q.shape[1] if q.dim() == 4 else 1
    return choose_kv_splits(slots, hkv * row_tiles(sq, hq // hkv, rows),
                            block_tables.shape[1], k_pages.shape[1],
                            sm_count, per_sm, tokens)


def verify_splits(q, k_pages, v_pages, block_tables, sm_count):
    """The split count paged_attention_multi chooses for q [slots, sq, hq,
    d] (and paged_attention for a decode step the decode kernel does not
    take, as sq = 1)."""
    return _splits(route(q, k_pages, v_pages), q, k_pages, block_tables,
                   sm_count)


def decode_splits(q, k_pages, v_pages, block_tables, sm_count):
    """The split count paged_attention chooses for q [slots, hq, d]."""
    return _splits(route(q, k_pages, v_pages), q, k_pages, block_tables,
                   sm_count)


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _entry(name="paged_attention_decode", ints=8):
    fn = getattr(_build.load("paged_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * ints + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def _kernel(q, k_pages, v_pages, block_tables, context_lens, scale,
            kv_splits, kernel):
    _check(q, k_pages, v_pages, block_tables, context_lens, kv_splits)
    slots, hq, d = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    out = torch.empty_like(q)
    if kv_splits > 1:
        part_acc = torch.empty(slots * hkv * kv_splits * g * d,
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty(slots * hkv * kv_splits * g * 2,
                              dtype=torch.float32, device=q.device)
        pa, pml = part_acc.data_ptr(), part_ml.data_ptr()
    else:
        pa = pml = None
    status = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        pa, pml, slots, hkv, g, d, bs, block_tables.shape[1], kv_splits,
        kernel, float(scale), _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check_status(status, "paged_attention_decode")
    _counts.count(paged_attention)
    return out


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None, kv_splits=None):
    """One decode step of ragged paged attention; returns [slots, q_heads,
    d] in q's dtype. CUDA tensors launch the kernel `route` chooses (the
    decode kernel, or the verify kernel as a window of one token), split-K
    over each slot's context into `kv_splits` runs (None: decode_splits);
    CPU tensors take the plain version. A slot with context 0 gets zeros
    from the kernel and the mean of its gathered V from the plain version
    (as from the reference's two paths); the engine never asks for one."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     context_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    kernel = route(q, k_pages, v_pages)
    if kv_splits is None:
        kv_splits = _splits(kernel, q, k_pages, block_tables,
                            _sm_count(q.device))
    return _kernel(q, k_pages, v_pages, block_tables, context_lens, scale,
                   int(kv_splits), kernel)


paged_attention.launches = 0


def _verify_kernel(q, k_pages, v_pages, block_tables, context_lens, scale,
                   kv_splits, kernel):
    _check(q, k_pages, v_pages, block_tables, context_lens, kv_splits)
    slots, sq, hq, d = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    out = torch.empty_like(q)
    if kv_splits > 1:
        rows = slots * hkv * kv_splits * sq * g
        part_acc = torch.empty(rows * d, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
        pa, pml = part_acc.data_ptr(), part_ml.data_ptr()
    else:
        pa = pml = None
    status = _entry("paged_attention_verify", 9)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        pa, pml, slots, sq, hkv, g, d, bs, block_tables.shape[1], kv_splits,
        kernel, float(scale), _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check_status(status, "paged_attention_verify")
    _counts.count(paged_attention_multi)
    return out


def row_tiles(sq, g, rows=ROW_TILE):
    """Row tiles of the verify kernel's grid: `rows` (query, head) rows a
    block (ROW_TILE on the CUDA cores, MMA_ROW_TILE on the tensor cores),
    sq * g rows a (slot, kv head)."""
    return -(-sq * g // rows)


def paged_attention_multi(q, k_pages, v_pages, block_tables, context_lens,
                          scale=None, kv_splits=None):
    """The speculative verify window: q [slots, sq, q_heads, d] against the
    paged pool, context_lens the tokens cached BEFORE the window (the
    window's own K/V are already in the pages), query i of a slot seeing
    positions < context_lens + i + 1. Returns q's shape and dtype. CUDA
    tensors launch the verify kernel, split-K over each slot's context into
    `kv_splits` runs (None: verify_splits); CPU tensors take the plain
    version. (The reference's TPU path runs one split.)"""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_multi_plain(q, k_pages, v_pages, block_tables,
                                           context_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_multi: no kernel for {q.device}")
    kernel = route(q, k_pages, v_pages)
    if kv_splits is None:
        kv_splits = _splits(kernel, q, k_pages, block_tables,
                            _sm_count(q.device))
    return _verify_kernel(q, k_pages, v_pages, block_tables, context_lens,
                          scale, int(kv_splits), kernel)


paged_attention_multi.launches = 0
