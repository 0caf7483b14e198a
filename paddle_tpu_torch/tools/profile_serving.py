"""Where a serving tick's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_serving

Builds Llama-2-7B (bf16, seeded random weights) behind ServingEngine (8 slots,
16-token blocks, 256-token prefill chunks, 2048 context), fills all 8 slots
with distinct 512-token prompts, and traces with torch.profiler:

  * `decode`: 8 engine ticks that only decode (every slot running);
  * `prefill`: one tick that prefills a 256-token chunk beside 7 decoding
    slots.

For each it prints one JSON line: host wall time per tick (synchronised;
for decode also without the profiler, which slows the host), device busy
time per tick (the union of the kernels' intervals), the busy share,
kernels per tick, and the kernels with the most device time (names cut to
80 characters). Needs one CUDA device.
"""
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
    return {
        "ticks": ticks, "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_busy_ms_per_tick": busy / ticks,
        "device_busy_share": busy / (wall * 1e3) if wall else None,
        "kernels_per_tick": len(kernels) / ticks,
        "top_device_ms_per_tick": {n: t / 1e3 / ticks for n, t in top},
    }


def main():
    import numpy as np
    import torch

    from ..models import LlamaConfig, LlamaForCausalLM
    from ..serving import ServingEngine

    cfg = LlamaConfig.llama2_7b()
    model = LlamaForCausalLM(cfg, dtype="bfloat16", seed=0)
    eng = ServingEngine(model, max_slots=8, block_size=16, prefill_chunk=256,
                        max_model_len=2048)
    rng = np.random.default_rng(0)

    def prompt(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    for _ in range(8):
        eng.submit(prompt(512), max_new_tokens=200)
    while eng.sched.waiting or eng.sched.prefilling:
        eng.step()
    for _ in range(3):                      # warm the decode path
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        eng.step()
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) * 1e3 / 8
    decode = _profile(torch, eng.step, 8)
    print(json.dumps({"phase": "decode", "wall_ms_per_tick_unprofiled":
                      unprofiled, **decode}), flush=True)

    # free one slot, then trace the tick that admits a new prompt and
    # prefills its first chunk beside the 7 decoding slots
    victim = next(iter(eng.sched.running.values()))
    eng.cancel(victim)
    eng.submit(prompt(600), max_new_tokens=8)
    prefill = _profile(torch, eng.step, 1)
    print(json.dumps({"phase": "prefill", "chunk": 256, **prefill}),
          flush=True)


if __name__ == "__main__":
    main()
