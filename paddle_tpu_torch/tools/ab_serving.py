"""One side of a serving A/B between two checkouts on the same card.

    cd <checkout> && python3 /path/to/paddle_tpu_torch/tools/ab_serving.py \
        LABEL [slice sampled_slice tick batched_prefill spec_slice]

Run as a file from the root of a checkout (the parent's or this one's): it
drives that checkout's package, with the measuring code of this file and
of its sibling profile_serving.py (loaded by path), so both trees are
timed by the same code. It loads Llama-2-7B (bf16, seed 0) and prints one
JSON line a measurement (all of them, or those named after LABEL), each
with the card's name and power limit:

  * `slice`: chip_smoke.py's serving slice (10 requests in two waves,
    prompts 16-1024 tokens, 64 new tokens each, 8 slots, 2048 context) at
    fuse_steps 1 and 4 (where the engine has it): tokens/s, mean TTFT,
    wall, engine construction time, peak device memory;
  * `sampled_slice`: the same requests, every other one at temperature
    0.8, fuse_steps 4;
  * `spec_slice`: the checkout's chip_smoke.spec_slice_phase (spec_k 4
    against 0, seeded and zero-head arms): tokens/s and TTFT of each run;
  * `tick`: steady ticks of each kind, 8 slots at 512 context:
    `decode` (greedy), `sampled` (every request at temperature 0.8),
    `verify` (spec_k 4, the head zeroed so every slot drafts), and
    `prefill` (one 256-token chunk a tick on an idle engine): wall ms a
    tick unprofiled and profiled, device busy ms and share, kernels a tick;
    `batched_prefill` (profile_serving.batched_prefill_calls): bursts of 8
    fresh prompts of 16-48 tokens (`p256`: one 256-token workspace) and of
    8 prompts of 40 fresh tokens on a cached 2,000-token prefix
    (`offset2000`: the longest workspace), each through one batched
    prefill call: wall ms a call, device busy ms a burst; with it,
    `engine_init`, the engine's construction seconds (graph captures
    included) and its graph count.

For an A/B, run it in turns (parent, change, change, parent) in one call;
the kernels are the same sources, so one build serves both trees (copy
`paddle_tpu_torch/build/`). Needs one CUDA device.
"""
import importlib.util
import inspect
import json
import os
import statistics
import sys
import time

SLICE_LENS = (16, 64, 128, 512, 768, 1024, 288, 356)
PREFIX = 256


def _profile_tools():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "profile_serving.py")
    spec = importlib.util.spec_from_file_location("_ab_profile", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def slice_prompts(np, vocab, block_size=16):
    """chip_smoke.slice_phase's two waves (the same seed and order)."""
    rng = np.random.default_rng(1)

    def toks(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    shared = toks(PREFIX)
    wave1 = [toks(n) for n in SLICE_LENS[:-2]]
    wave1 += [shared + toks(n - PREFIX) for n in SLICE_LENS[-2:]]
    repeat = next(p for p in wave1 if len(p) % block_size == 0)
    return [wave1, [shared + toks(48), list(repeat)]]


def serve(torch, engine_cls, model, kw, waves, temperature=0.0,
          new_tokens=64):
    """Construct an engine and run the waves dry, every other request at
    `temperature`. Returns the run's figures."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = engine_cls(model, **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reqs = []
    t1 = time.perf_counter()
    for wave in waves:
        reqs += [eng.submit(p, max_new_tokens=new_tokens,
                            temperature=temperature if i % 2 else 0.0)
                 for i, p in enumerate(wave, start=len(reqs))]
        eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    generated = sum(len(r.output_tokens) for r in reqs)
    return {"tokens_per_s": generated / wall, "wall_s": wall,
            "mean_ttft_s": statistics.mean(r.ttft_seconds() for r in reqs),
            "init_s": init_s, "engine_steps": eng.steps,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "graphs": (eng.graph_stats() if hasattr(eng, "graph_stats")
                       else None)}


def main(label, only=()):
    """Run every measurement, or those named in `only` (slice,
    sampled_slice, tick, batched_prefill, spec_slice)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.ops.gpu import _build
    from paddle_tpu_torch.serving import ServingEngine

    def want(what):
        return not only or what in only

    ps = _profile_tools()
    card = cs.nvidia_smi()
    _build.build_all()
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(), device="cuda",
                             dtype="bfloat16", seed=0)
    vocab = model.config.vocab_size
    kw = dict(max_slots=8, block_size=16, prefill_chunk=256,
              max_model_len=2048)
    fused = "fuse_steps" in inspect.signature(ServingEngine).parameters
    fuse4 = dict(kw, fuse_steps=4) if fused else dict(kw)

    def emit(what, row, **keys):
        print(json.dumps({"ab": label, "card": card, "what": what, **keys,
                          **row}), flush=True)

    waves = slice_prompts(np, vocab)
    if want("slice"):
        for fuse in ((1, 4) if fused else (None,)):
            ekw = dict(kw) if fuse is None else dict(kw, fuse_steps=fuse)
            emit("slice", serve(torch, ServingEngine, model, ekw, waves),
                 fuse_steps=fuse)
            cs.release(torch)
    if want("sampled_slice"):
        emit("sampled_slice", serve(torch, ServingEngine, model, fuse4,
                                    waves, temperature=0.8),
             fuse_steps=fuse4.get("fuse_steps"), temperature=0.8)
        cs.release(torch)

    rng = np.random.default_rng(0)

    def prompts(n, count, pattern=False):
        if pattern:
            return [[int(t) for t in np.resize(rng.integers(
                1, vocab, int(rng.integers(16, 49))), n)]
                for _ in range(count)]
        return [[int(t) for t in rng.integers(0, vocab, n)]
                for _ in range(count)]

    ticks = {
        "decode": lambda: ps.steady_ticks(
            torch, ServingEngine(model, **kw), prompts(512, 8)),
        "sampled": lambda: ps.steady_ticks(
            torch, ServingEngine(model, **kw), prompts(512, 8),
            temperature=0.8),
        "prefill": lambda: ps.prefill_ticks(
            torch, ServingEngine(model, **kw), prompts(2000, 2)),
    }
    for kind, fn in ticks.items():
        if want("tick"):
            emit("tick", fn(), kind=kind)
            cs.release(torch)
    if want("batched_prefill"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = ServingEngine(model, **kw)
        torch.cuda.synchronize()
        emit("engine_init", {"init_s": time.perf_counter() - t0,
                             "graphs": len(getattr(eng, "_graphs", ()))})
        emit("tick", ps.batched_prefill_calls(torch, eng, lambda: [
            [int(t) for t in rng.integers(0, vocab, int(n))]
            for n in rng.choice((16, 32, 48), 8)]),
            kind="batched_prefill", case="p256")
        prefix = [int(t) for t in rng.integers(0, vocab, 2000)]
        eng.generate([prefix + [1]], max_new_tokens=1)   # caches it
        emit("tick", ps.batched_prefill_calls(torch, eng, lambda: [
            prefix + [int(t) for t in rng.integers(0, vocab, 40)]
            for _ in range(8)]), kind="batched_prefill", case="offset2000")
        del eng
        cs.release(torch)
    # the verify tick and the spec slice zero the head: last, then restored
    head = model.lm_head.weight.detach().clone()
    if want("tick"):
        eng = ServingEngine(model, **dict(kw, spec_k=4))
        with torch.no_grad():
            model.lm_head.weight.zero_()
        row = ps.steady_ticks(torch, eng, prompts(512, 8, pattern=True))
        emit("tick", row, kind="verify")
        del eng
        cs.release(torch)
        with torch.no_grad():
            model.lm_head.weight.copy_(head)
    if want("spec_slice"):
        spec = cs.spec_slice_phase(
            torch, model, dict(kw, spec_k=4, spec_ngram=3, spec_pause=32),
            new_tokens=64, reset=gpu.reset_launch_counts,
            counts=lambda: gpu.launch_counts(cs.SPEC), kernels=cs.SPEC)
        for arm, runs in spec["arms"].items():
            emit("spec_slice", {k: {f: runs[k][f] for f in (
                "tokens_per_s", "mean_ttft_s", "wall_s", "decode_ticks")}
                for k in ("spec", "plain")}, arm=arm)
        with torch.no_grad():
            model.lm_head.weight.copy_(head)


if __name__ == "__main__":
    main(sys.argv[1], set(sys.argv[2:]))
