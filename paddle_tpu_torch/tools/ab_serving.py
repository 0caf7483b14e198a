"""One side of a serving A/B between two checkouts on the same card.

    cd <checkout> && python3 /path/to/paddle_tpu_torch/tools/ab_serving.py LABEL

Run as a file from the root of a checkout (the parent's or this one's): it
imports that checkout's `chip_smoke.py` and package, so one copy of this
script times both trees. It loads Llama-2-7B (bf16, seed 0), runs
`chip_smoke.slice_phase` (10 requests x 64 tokens, 8 slots; at fuse_steps
1 and 4 where the engine has them) and then the steady decode ticks of
`tools/profile_serving.py` (8 slots at 512 context: 8 ticks unprofiled,
8 profiled), printing one JSON line each with the card's name and power
limit. For an A/B, run it in turns (parent, change, change, parent) in one
call; the kernels are the same sources, so one build serves both trees
(copy `paddle_tpu_torch/build/`). Needs one CUDA device.
"""
import inspect
import json
import os
import sys
import time


def main(label):
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.ops.gpu import _build
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.tools import profile_serving as ps

    card = cs.nvidia_smi()
    _build.build_all()
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(), device="cuda",
                             dtype="bfloat16", seed=0)
    kw = dict(max_slots=8, block_size=16, prefill_chunk=256,
              max_model_len=2048)
    fused = "fuse_steps" in inspect.signature(ServingEngine).parameters
    fuses = (1, 4) if fused else (None,)

    def engine_kw(fuse):
        return dict(kw) if fuse is None else dict(kw, fuse_steps=fuse)

    def emit(what, fuse, row):
        print(json.dumps({"ab": label, "card": card, "what": what,
                          "fuse_steps": fuse, **row}), flush=True)

    for fuse in fuses:
        out = cs.slice_phase(
            torch, model, engine_kw(fuse), new_tokens=64,
            wave1_lens=(16, 64, 128, 512, 768, 1024, 288, 356),
            prefix_len=256, reset=gpu.reset_launch_counts,
            counts=lambda: gpu.launch_counts(cs.SERVING))
        summary = out[1] if isinstance(out, tuple) else out
        emit("slice", fuse, {k: summary[k] for k in (
            "tokens_per_s", "mean_ttft_s", "wall_s", "engine_steps")})
        cs.release(torch)
    for fuse in fuses:
        eng = ServingEngine(model, **engine_kw(fuse))
        rng = np.random.default_rng(0)
        for _ in range(8):
            eng.submit([int(t) for t in rng.integers(0, 32000, 512)],
                       max_new_tokens=400)
        while eng.sched.waiting or eng.sched.prefilling:
            eng.step()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 8
        prof = ps._profile(torch, eng.step, 8)
        emit("decode_tick", fuse, {
            "wall_ms_per_tick_unprofiled": wall,
            **{k: prof[k] for k in (
                "wall_ms_per_tick", "device_busy_ms_per_tick",
                "device_busy_share", "kernels_per_tick",
                "paged_decode_ms_per_tick", "rope_launches_per_tick")}})
        del eng
        cs.release(torch)


if __name__ == "__main__":
    main(sys.argv[1])
