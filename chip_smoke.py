#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path on one H100 and hold each of its
hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
final line):

  1. device  - the card's name and power limit (nvidia-smi); capability 9.0
  2. build   - nvcc builds every CUDA source under paddle_tpu_torch/csrc/
  3. kernels - each kernel against its plain version on the card, in bf16
               and fp32, at the serving path's shapes: max |error| within the
               stated tolerance, and median time (CUDA events) beside the
               plain version's, one PyTorch library call's where one computes
               the same function (a yardstick only; the port never calls it),
               and the bound: the larger of bytes moved / 3.35 TB/s and
               operations / the peak rate of the input type. Paged decode
               runs at the main path's shapes with the split count the
               wrapper chooses there and with one split
  4. parity  - Llama at full width, 2 layers, fp32 (TF32 off), seeded
               weights: ServingEngine.generate must equal model.generate token
               for token, greedy
  5. slice   - the main path: Llama-2-7B at full depth in bf16 served by
               ServingEngine (8 slots, 16-token blocks, 2048 context) over 10
               requests (prompts 16-1024 tokens, two sharing a 256-token
               prefix, one repeated for a copy-on-write hit), 64 new tokens
               each; every kernel's launch count over this phase must be > 0

The last two lines are the kernel summary {"kernels": [...]} and
{"ok": true, "device": {...}}. Exits non-zero without them when no CUDA
device is present or the package is not beside this script.
"""
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(fn, iters=20, reps=5):
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes, nops, dtype):
    """(least time in ms, what bounds it) for this work on an H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / PEAK_OPS_PER_S[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ kernel cases
def _tol(dtype):
    import torch

    # Both sides do the same fp32 arithmetic in another order (max |error|
    # measured at most 1.2e-6 in fp32); in bf16 both then round that fp32
    # value once, so they may differ by one bf16 ulp, at most 2**-7 of the
    # value. The fp32 slack stays as the absolute term in both dtypes.
    return (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2.0 ** -7)


def _compare(name, shape, dtype, got, want):
    import torch

    atol, rtol = _tol(dtype)
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    if not ok:
        raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees with "
                             f"the plain version (max abs err "
                             f"{err.max().item():.3g}, atol {atol}, rtol "
                             f"{rtol:.3g})")
    return float(err.max())


def rms_case(torch, gen, dtype, n, d=4096):
    from paddle_tpu_torch.ops.gpu import fused_norm

    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    es = x.element_size()
    return dict(
        name="rms_norm", shape=[n, d],
        kernel=lambda: fused_norm.fused_rms_norm(x, w, eps),
        plain=lambda: fused_norm.rms_norm_plain(x, w, eps),
        library=lambda: torch.nn.functional.rms_norm(x, (d,), w, eps),
        nbytes=2 * n * d * es + d * es, nops=4 * n * d)


def rope_case(torch, gen, dtype, s, h=32, d=128, start=512):
    from paddle_tpu_torch.ops.gpu import rope

    x = torch.randn(1, s, h, d, device="cuda", generator=gen).to(dtype)
    cos_t, sin_t = _tables(torch, 4096, d)
    cos, sin = cos_t[start:start + s].contiguous(), \
        sin_t[start:start + s].contiguous()
    return dict(
        name="rope", shape=[1, s, h, d],
        kernel=lambda: rope.rope(x, cos, sin),
        plain=lambda: rope.rope_plain(x, cos, sin), library=None,
        nbytes=2 * x.numel() * x.element_size() + 2 * s * d * 4,
        nops=3 * x.numel())


def rope_packed_case(torch, gen, dtype, b, s, h=32, d=128, P=4096):
    from paddle_tpu_torch.ops.gpu import rope

    x = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    cos_t, sin_t = _tables(torch, P, d)
    # ragged offsets, some rows running past the table's last position
    base = torch.randint(0, P + 64 - s, (b,), device="cuda", generator=gen)
    pos = (base[:, None] + torch.arange(s, device="cuda")[None]).to(
        torch.int32).contiguous()
    rows = int(torch.unique(pos.clamp(0, P - 1)).numel())
    return dict(
        name="rope_packed", shape=[b, s, h, d],
        kernel=lambda: rope.rope_packed(x, cos_t, sin_t, pos),
        plain=lambda: rope.rope_packed_plain(x, cos_t, sin_t, pos),
        library=None,
        nbytes=(2 * x.numel() * x.element_size() + pos.numel() * 4
                + 2 * rows * d * 4),
        nops=3 * x.numel())


def paged_case(torch, gen, dtype, slots, hq, hkv, d, bs, ctx_lens,
               splits=None):
    """splits=None leaves the split count to the wrapper, as the serving
    path does (the printed shape then holds the count it chooses)."""
    from paddle_tpu_torch.ops.gpu import paged_attention as pa

    max_ctx = max(ctx_lens)
    maxb = -(-max_ctx // bs)
    shown = splits if splits is not None else pa.choose_kv_splits(
        slots, hkv, maxb, bs,
        torch.cuda.get_device_properties(0).multi_processor_count)
    nb = slots * maxb + 1
    kp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    q = torch.randn(slots, hq, d, device="cuda", generator=gen).to(dtype)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    bt = perm[:slots * maxb].reshape(slots, maxb).to(torch.int32)
    cl = torch.tensor(ctx_lens, dtype=torch.int32, device="cuda")
    for r, c in enumerate(ctx_lens):      # null pages past each context
        bt[r, -(-c // bs):] = 0
    bt = bt.contiguous()
    scale = d ** -0.5
    # yardstick: one SDPA call over K/V already gathered (gather not timed)
    kg = kp[bt.long()].reshape(slots, maxb * bs, hkv, d)
    vg = vp[bt.long()].reshape(slots, maxb * bs, hkv, d)
    kg = kg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(maxb * bs, device="cuda")[None, :]
            < cl[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    es = q.element_size()
    live = sum(ctx_lens)
    return dict(
        name="paged_decode",
        shape=[slots, hq, hkv, d, bs, max_ctx, shown],
        kernel=lambda: pa.paged_attention(q, kp, vp, bt, cl, scale, splits),
        plain=lambda: pa.paged_attention_plain(q, kp, vp, bt, cl, scale),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale),
        nbytes=(2 * live * hkv * d * es + 2 * q.numel() * es
                + sum(-(-c // bs) for c in ctx_lens) * 4 + slots * 4),
        nops=4 * live * hq * d)


def _tables(torch, P, d, theta=10000.0):
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device="cuda") / d))
    f = torch.outer(torch.arange(P, dtype=torch.float32, device="cuda"), inv)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos().contiguous(), emb.sin().contiguous()


def run_case(torch, case, dtype):
    got, want = case["kernel"](), case["plain"]()
    torch.cuda.synchronize()
    err = _compare(case["name"], case["shape"], dtype, got, want)
    lib = case["library"]
    b_ms, b_by = bound_ms(case["nbytes"], case["nops"], dtype)
    row = {
        "phase": "kernels", "name": case["name"], "shape": case["shape"],
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "tolerance": dict(zip(("atol", "rtol"), _tol(dtype))),
        "ms": time_ms(case["kernel"]), "plain_ms": time_ms(case["plain"]),
        "library_ms": time_ms(lib) if lib is not None else None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit(row)
    return row


def kernels_phase(torch):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases = [
            ("rms_norm", rms_case(torch, gen, dtype, 8)),          # decode
            (None, rms_case(torch, gen, dtype, 256)),              # chunk
            ("rope", rope_case(torch, gen, dtype, 256)),           # chunk
            ("rope_packed", rope_packed_case(torch, gen, dtype, 8, 1)),
            (None, rope_packed_case(torch, gen, dtype, 8, 128)),   # batched
            # decode at the main path's table width (2048 / 16 = 128 pages):
            # the wrapper's own split count, then the single-split side
            ("paged_decode", paged_case(
                torch, gen, dtype, 8, 32, 32, 128, 16,
                [2048, 1791, 1500, 1203, 900, 611, 300, 17])),
            (None, paged_case(torch, gen, dtype, 8, 32, 32, 128, 16,
                              [2048, 1791, 1500, 1203, 900, 611, 300, 17],
                              splits=1)),
        ]
        for g, ctx in ((2, [77, 5, 300]), (4, [1, 129, 640]),
                       (8, [33, 1000, 16])):
            cases.append((None, paged_case(torch, gen, dtype, 3, 8 * g, 8,
                                           128, 16, ctx, splits=2)))
        for key, case in cases:
            row = run_case(torch, case, dtype)
            if key is not None and dtype == torch.bfloat16:
                rows[key] = row
            del case
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------- served path
def top2_margin(torch, model, seq, t):
    """Gap between the two largest logits predicting token t of seq."""
    with torch.no_grad():
        ids = torch.tensor([seq[:t]], device=model.device)
        lg = model(ids)[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def parity_phase(torch, cfg, device, new_tokens=16, engine_kw=None,
                 prompt_lens=(700, 40, 23, 300)):
    """ServingEngine.generate vs model.generate, greedy, token for token."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=SEED)
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in prompt_lens]
    eng = ServingEngine(model, device=device, **(engine_kw or {}))
    got = eng.generate(prompts, max_new_tokens=new_tokens)
    for p, g in zip(prompts, got):
        want = model.generate(torch.tensor([p], device=model.device),
                              max_new_tokens=new_tokens)[0].tolist()
        if g != want:
            t = next(i for i, (a, b) in enumerate(zip(g, want)) if a != b)
            raise AssertionError(
                f"engine and generate() diverge at token {t} of a "
                f"{len(p)}-token prompt ({g[t]} vs {want[t]}); top-2 logit "
                f"margin there {top2_margin(torch, model, want, t):.3g}")
    st = eng.stats()
    return {"phase": "parity", "prompts": [len(p) for p in prompts],
            "new_tokens": new_tokens, "token_match": True,
            "batched_prefills": st["batched_prefills"],
            "prefill_programs": st["prefill_programs"]}


def slice_phase(torch, cfg, device, dtype, engine_kw, new_tokens,
                wave1_lens, prefix_len, reset, counts):
    """The main path: waves of requests through ServingEngine. Returns the
    phase summary; launch counts are read just after the drive."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=SEED)
    eng = ServingEngine(model, device=device, **engine_kw)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 1)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    shared = toks(prefix_len)
    lens = list(wave1_lens)
    wave1 = [toks(n) for n in lens[:-2]]
    wave1 += [shared + toks(lens[-2] - prefix_len),
              shared + toks(lens[-1] - prefix_len)]
    # wave 2: a partial prefix hit and a full-prompt (copy-on-write) hit
    repeat = next(p for p in wave1 if len(p) % engine_kw["block_size"] == 0)
    wave2 = [shared + toks(48), list(repeat)]
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    reqs = []
    decode_tick = None
    reset()
    t1 = time.perf_counter()
    for wave in (wave1, wave2):
        reqs += [eng.submit(p, max_new_tokens=new_tokens) for p in wave]
        while eng.sched.has_work():
            pure = not eng.sched.waiting and not eng.sched.prefilling
            before = counts()
            eng.step()
            if pure and decode_tick is None:
                after = counts()
                decode_tick = {k: after[k] - before[k] for k in after}
    sync()
    wall = time.perf_counter() - t1
    launches = counts()
    short = [r.request_id for r in reqs
             if len(r.output_tokens) != new_tokens
             or not all(0 <= t < cfg.vocab_size for t in r.output_tokens)]
    if short:
        raise AssertionError(f"requests without their {new_tokens} valid "
                             f"tokens: {short}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    st = eng.stats()
    if st["kv"]["used_blocks"] or not st["kv"]["conservation_ok"]:
        raise AssertionError(f"KV blocks leaked: {st['kv']}")
    generated = sum(len(r.output_tokens) for r in reqs)
    return {
        "phase": "slice", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "dtype": str(dtype),
        "requests": len(reqs), "prompt_tokens": [len(r.prompt) for r in reqs],
        "new_tokens_each": new_tokens, "init_s": init_s, "wall_s": wall,
        "engine_steps": st["steps"], "generated_tokens": generated,
        "tokens_per_s": generated / wall,
        "mean_ttft_s": statistics.mean(r.ttft_seconds() for r in reqs),
        "prefill_tokens": st["prefill_tokens"],
        "batched_prefills": st["batched_prefills"],
        "cow_admissions": st["cow_admissions"],
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if device != "cpu" else None),
        "kv_pool_bytes": eng.pool.nbytes(),
        "launches": launches, "launches_per_decode_tick": decode_tick,
    }


KERNELS = {
    "rms_norm": ("triton", "paddle_tpu_torch/ops/gpu/fused_norm.py",
                 "paddle_tpu/ops/pallas/fused_norm.py:24"),
    "rope": ("triton", "paddle_tpu_torch/ops/gpu/rope.py",
             "paddle_tpu/ops/pallas/rope.py:22"),
    "rope_packed": ("triton", "paddle_tpu_torch/ops/gpu/rope.py",
                    "paddle_tpu/ops/pallas/rope.py:126"),
    "paged_decode": ("cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:50"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.models import LlamaConfig
        from paddle_tpu_torch.ops import gpu
        from paddle_tpu_torch.ops.gpu import _build
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2

    card = nvidia_smi()
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": card, "capability": list(cap),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {k: v["seconds"] for k, v in built.items()},
          "ptxas": [ln.strip() for v in built.values()
                    for ln in v["log"].splitlines() if "Used" in ln]})

    rows = kernels_phase(torch)
    torch.cuda.empty_cache()

    cfg2 = LlamaConfig.llama2_7b()
    cfg2.num_layers = 2
    emit(parity_phase(torch, cfg2, "cuda", engine_kw=dict(
        max_slots=4, block_size=16, prefill_chunk=256, max_model_len=1024)))
    torch.cuda.empty_cache()

    summary = slice_phase(
        torch, LlamaConfig.llama2_7b(), "cuda", "bfloat16",
        dict(max_slots=8, block_size=16, prefill_chunk=256,
             max_model_len=2048),
        new_tokens=64, wave1_lens=(16, 64, 128, 512, 768, 1024, 288, 356),
        prefix_len=256, reset=gpu.reset_launch_counts,
        counts=gpu.launch_counts)
    emit(summary)

    print(card, flush=True)
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": summary["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:           # any failed phase: report it, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
