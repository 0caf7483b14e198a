"""Where a serving tick's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_serving [--model llama|gpt]
                                                      [--spec-k K]
                                                      [--fuse-steps K]
                                                      [--temperature T]

Builds Llama-2-7B (bf16, seeded random weights; `--model gpt`: GPT-3 1.3B)
behind ServingEngine (8 slots, 16-token blocks, 256-token prefill chunks,
2048 context, speculation with `--spec-k` drafts a tick, default 0, and
`--fuse-steps` greedy steps a tick, default 1), fills all 8 slots with
distinct 512-token prompts (with --spec-k, each a seeded 16-48-token
pattern repeated, the traffic speculation serves; with --temperature > 0,
every request samples at it, so every decode tick is a sampled one), and
traces with torch.profiler:

  * `decode`: 8 engine ticks that only decode (every slot running): greedy
    ticks replay the fuse_steps-step graph, sampled ticks the one-step
    sampled graph;
  * `prefill`: one tick that prefills a 256-token chunk beside 7 decoding
    slots;
  * `prefill_chunk`: ticks that prefill one 256-token chunk of a long
    prompt and nothing else (an idle engine; each replays a prefill
    graph), 6 unprofiled and 6 profiled;
  * with --spec-k: `verify_tick`, the first tick (of up to 64) that runs a
    verify window, and `plain_tick`, the next tick run with speculation
    switched off, from the same engine state: one verify tick beside one
    plain decode tick, with the verify kernel's share of the device time.
    With --spec-k the model's head is zeroed, so every target is token 0
    (the reference's deterministic speculation case): random weights need
    not repeat their own history, and without drafts there is no verify
    tick to trace. A tick's device work does not depend on the head's
    values.

For each it prints one JSON line: host wall time per tick (synchronised;
for decode and prefill_chunk also without the profiler, which slows the
host, and per decode step), device busy
time per tick (the union of the kernels' intervals), the busy share,
kernels per tick, the paged decode kernels' (with their split combine)
and the verify kernels' device time per tick and share of the busy time,
the RoPE kernel's device time and launches per tick (one launch a layer
rotates q and k), the engine's graph replays and ticks by kind, and the
kernels with the most device time (names cut to 80 characters).
`steady_ticks`, `prefill_ticks` and `batched_prefill_calls` (a burst of
short prompts through one batched prefill call) measure ticks for
tools/ab_serving.py. Needs one CUDA device.
"""
import argparse
import json
import time


def _busy_us(events):
    """Union of device-kernel intervals, microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _profile(torch, fn, ticks):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == cuda]
    by_name = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy = _busy_us(kernels) / 1e3
    verify = sum(t for n, t in by_name.items() if "paged_verify" in n) / 1e3
    decode = sum(t for n, t in by_name.items()
                 if "paged_decode" in n or "paged_combine" in n) / 1e3
    rope = [e.time_range.end - e.time_range.start for e in kernels
            if "rope_qk_kernel" in e.name]
    return {
        "paged_verify_ms_per_tick": verify / ticks,
        "paged_verify_share": verify / busy if busy else None,
        "paged_decode_ms_per_tick": decode / ticks,
        "paged_decode_share": decode / busy if busy else None,
        "rope_ms_per_tick": sum(rope) / 1e3 / ticks,
        "rope_launches_per_tick": len(rope) / ticks,
        "ticks": ticks, "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_busy_ms_per_tick": busy / ticks,
        "device_busy_share": busy / (wall * 1e3) if wall else None,
        "kernels_per_tick": len(kernels) / ticks,
        "top_device_ms_per_tick": {n: t / 1e3 / ticks for n, t in top},
    }


def steady_ticks(torch, eng, prompts, ticks=8, temperature=0.0):
    """Fill every slot with `prompts` (400 new tokens each, at
    `temperature`), run 3 ticks, then time `ticks` ticks unprofiled (one
    synchronise after them) and `ticks` profiled. Returns the profile with
    `wall_ms_per_tick_unprofiled` and how many of the 2 x `ticks` measured
    ticks ran a verify window."""
    for p in prompts:
        eng.submit(p, max_new_tokens=400, temperature=temperature)
    while eng.sched.waiting or eng.sched.prefilling:
        eng.step()
    for _ in range(3):                      # warm the decode path
        eng.step()
    verify = getattr(eng, "spec_ticks", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) * 1e3 / ticks
    prof = _profile(torch, eng.step, ticks)
    return {"wall_ms_per_tick_unprofiled": unprofiled,
            "verify_ticks_measured": getattr(eng, "spec_ticks", 0) - verify,
            **prof}


def prefill_ticks(torch, eng, prompts, ticks=6):
    """Pure prefill ticks on an idle engine: each of two long prompts
    (> ticks + 1 chunks, run one after the other) prefills one chunk a
    tick; the first prompt's first `ticks` chunk ticks are timed
    unprofiled, the second's profiled. Returns the profile with
    `wall_ms_per_tick_unprofiled`."""
    out = {}
    for i, p in enumerate(prompts[:2]):
        req = eng.submit(p, max_new_tokens=1)
        eng.step()                          # admission and chunk 1
        torch.cuda.synchronize()
        if req.state != "prefill":
            raise RuntimeError("prefill_ticks needs prompts longer than "
                               f"{ticks + 1} chunks on an idle engine")
        if i == 0:
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.step()
            torch.cuda.synchronize()
            out["wall_ms_per_tick_unprofiled"] = (
                (time.perf_counter() - t0) * 1e3 / ticks)
        else:
            out.update(_profile(torch, eng.step, ticks))
        if req.state != "prefill":
            raise RuntimeError("a measured tick left prefill")
        eng.run_until_idle()
    return out


def batched_prefill_calls(torch, eng, make_prompts, calls=6):
    """Bursts of greedy prompts on an idle engine, each admitted and
    prefilled by one batched prefill call (the engine's
    `_batched_prefill`, a graph replay or an eager call): `make_prompts()`
    gives each burst's fresh prompts (a burst of prompts seen before would
    hit the prefix cache). The first burst warms up; then `calls` bursts
    are timed unprofiled (wall ms of the call alone, synchronised) and
    `calls` profiled (device busy ms of a burst: the call, the admission
    and the cancel). The requests are cancelled after each burst.
    Returns the profile with `wall_ms_per_call_unprofiled`."""

    def burst():
        reqs = [eng.submit(p, max_new_tokens=2) for p in make_prompts()]
        eng.sched.admit()
        batch = list(eng.sched.prefilling)
        if len(batch) != len(reqs):
            raise RuntimeError("a burst must fit the engine's idle slots")
        return reqs, batch

    def call_and_cancel(reqs, batch):
        eng._batched_prefill(batch)
        for r in reqs:
            eng.cancel(r)
        eng._flush_pending()

    walls = []
    # step() runs the call without autograd; so must this
    with torch.no_grad():
        for i in range(calls + 1):
            reqs, batch = burst()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._batched_prefill(batch)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
            for r in reqs:
                eng.cancel(r)
            eng._flush_pending()
        prof = _profile(torch, lambda: call_and_cancel(*burst()), calls)
    return {"wall_ms_per_call_unprofiled": sum(walls) / len(walls),
            "burst": len(batch), **prof}


def main(argv=None):
    import numpy as np
    import torch

    from ..models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                          LlamaForCausalLM)
    from ..serving import ServingEngine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama", "gpt"), default="llama")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--fuse-steps", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)
    if args.spec_k and args.fuse_steps > 1:
        ap.error("--spec-k and --fuse-steps > 1 exclude each other")
    if args.model == "gpt":
        cfg = GPTConfig.gpt3_1p3b()
        cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
        model = GPTForCausalLM(cfg, dtype="bfloat16", seed=0)
    else:
        cfg = LlamaConfig.llama2_7b()
        model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=0)
    if args.spec_k:
        head = (model.lm_head if model.lm_head is not None
                else model.gpt.wte)
        with torch.no_grad():
            head.weight.zero_()
    kw = dict(max_slots=8, block_size=16, prefill_chunk=256,
              max_model_len=2048, spec_k=args.spec_k,
              fuse_steps=args.fuse_steps)
    eng = ServingEngine(model, **kw)
    rng = np.random.default_rng(0)

    def prompt(n):
        if args.spec_k:
            pat = rng.integers(0, cfg.vocab_size, int(rng.integers(16, 49)))
            return [int(t) for t in np.resize(pat, n)]
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    decode = steady_ticks(torch, eng, [prompt(512) for _ in range(8)],
                          temperature=args.temperature)
    head = {"model": args.model, "spec_k": args.spec_k,
            "fuse_steps": args.fuse_steps, "temperature": args.temperature,
            "card": torch.cuda.get_device_name(0)}
    print(json.dumps({"phase": "decode", **head,
                      "wall_ms_per_step_unprofiled":
                          decode["wall_ms_per_tick_unprofiled"]
                          / (1 if args.temperature > 0 else args.fuse_steps),
                      "graphs": eng.graph_stats(), **decode}), flush=True)

    if args.spec_k:
        # one verify tick, then one plain tick from the state it left
        for _ in range(64):
            before = eng.spec_ticks
            tick = _profile(torch, eng.step, 1)
            if eng.spec_ticks > before:
                print(json.dumps({"phase": "verify_tick", **head,
                                  "window": args.spec_k + 1, **tick}),
                      flush=True)
                break
        else:
            print(json.dumps({"phase": "verify_tick", **head,
                              "error": "no verify tick in 64 ticks"}),
                  flush=True)
        eng.spec_k = 0
        print(json.dumps({"phase": "plain_tick", **head,
                          **_profile(torch, eng.step, 1)}), flush=True)
        eng.spec_k = args.spec_k

    # free one slot, then trace the tick that admits a new prompt and
    # prefills its first chunk beside the 7 decoding slots
    victim = next(iter(eng.sched.running.values()))
    eng.cancel(victim)
    eng.submit(prompt(600), max_new_tokens=8)
    prefill = _profile(torch, eng.step, 1)
    print(json.dumps({"phase": "prefill", **head, "chunk": 256, **prefill}),
          flush=True)
    for r in list(eng.sched.running.values()) + list(eng.sched.prefilling):
        eng.cancel(r)
    chunks = prefill_ticks(torch, eng, [prompt(2000), prompt(2000)])
    print(json.dumps({"phase": "prefill_chunk", **head, "chunk": 256,
                      "graphs": eng.graph_stats(), **chunks}), flush=True)


if __name__ == "__main__":
    main()
