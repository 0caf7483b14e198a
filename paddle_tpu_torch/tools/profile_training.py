"""Where a training step's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_training [--model gpt]
    python3 -m paddle_tpu_torch.tools.profile_training --amp O2
    python3 -m paddle_tpu_torch.tools.profile_training --model llama_packed

`gpt` (the default) builds GPT-3 1.3B (seeded random weights, dropout 0) at
batch 4 x 2048, as chip_smoke.py's train_slice phase drives it.
`llama_packed` builds Llama-2-7B at its published widths cut to 8 layers
(`packed_llama_config`) and trains it on one packed batch of 2 rows x 4096
tokens (`packed_batch`: seeded documents of 64-2048 tokens through
PackedLMBatches), as chip_smoke.py's train_packed_slice phase drives it.
Both run AdamW (lr 1e-4, weight decay 0.01) behind TrainStep under amp O1
(bf16) by default; `--amp O2` first decorates the model and the optimizer
(bf16 parameters and gradients, fp32 master weights updated by AdamW's
master form) and runs the loss under auto_cast(level="O2"), as
chip_smoke.py's train_o2_slice phase does (without its guard and
telemetry, so that the two levels differ in nothing else). After two
warm-up steps the tool times 3 steps without the profiler
(synchronised host clock), then traces 2 steps with torch.profiler and
prints one JSON line: host wall time per step (with and without the
profiler), device busy time per step (the union of the kernels' intervals),
the busy share, kernels per step, device time per step by group (the port's
kernels by name; cuBLAS GEMMs; ATen's copy kernels, which carry every
dtype cast and layout copy; everything else), the device time of each
GEMM by its operator and input shapes (forward and backward products
apart), and the kernels with the most device time (names cut to 80
characters). Needs one CUDA device.
"""
import argparse
import json
import subprocess
import time

from .profile_serving import _busy_us

# bf16 flash runs the tensor-core templates (`*_mma_kernel`), fp32 and
# fp16 the CUDA-core ones; both count under the same kernel
GROUPS = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_mma_kernel")),
          ("flash_dq", ("flash_dq_kernel", "flash_dq_mma_kernel")),
          ("flash_dkv", ("flash_dkv_kernel", "flash_dkv_mma_kernel")),
          ("rms_norm", ("rms_fwd_kernel",)),
          ("rms_norm_bwd", ("_rms_bwd", "_rms_dw")),
          ("rope", ("rope_qk_kernel",)),
          ("adamw", ("_adamw",)),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
          ("copy", ("copy_kernel",)))


def _group(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            # the segmented flash kernels are the dense templates with
            # kSeg, their last template argument, set
            if group.startswith("flash_") and "true>" in name:
                return "flash_seg_" + group[len("flash_"):]
            return group
    return "other"


def packed_llama_config(layers=8):
    """Llama-2-7B at meta-llama/Llama-2-7b-hf's published widths, depth cut
    to `layers`."""
    from ..models import LlamaConfig

    cfg = LlamaConfig.llama2_7b()
    cfg.num_layers = layers
    return cfg


def packed_batch(vocab, rows=2, capacity=4096, seed=0):
    """The first (ids, segments, labels) batch of PackedLMBatches over a
    seeded corpus of documents with lengths uniform in [64, 2048] tokens
    (about four to a 4096-token row; documents split at row ends)."""
    import numpy as np

    from ..io import PackedLMBatches

    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, 2049, 8 * rows * capacity // 64)
    docs = (rng.integers(0, vocab, int(n)) for n in lengths)
    return next(iter(PackedLMBatches(docs, capacity, rows)))


def _build(model_name, level="O1"):
    """(TrainStep, batch tuple on the card, model label) at amp `level`."""
    import numpy as np
    import torch

    from .. import amp
    from ..jit import TrainStep
    from ..models import GPTConfig, GPTForCausalLM, LlamaForCausalLM
    from ..optimizer import AdamW

    if model_name == "gpt":
        cfg = GPTConfig.gpt3_1p3b()
        cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
        model = GPTForCausalLM(cfg, seed=0)

        def loss_fn(ids):
            with amp.auto_cast(level=level, dtype="bfloat16"):
                return model(ids, labels=ids)

        batch = (torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 2048))).cuda(),)
        label = "GPT-3 1.3B"
    else:
        cfg = packed_llama_config()
        model = LlamaForCausalLM(cfg, seed=0)

        def loss_fn(ids, seg, labels):
            with amp.auto_cast(level=level, dtype="bfloat16"):
                return model(ids, labels=labels, segments=seg)

        batch = tuple(torch.from_numpy(a).cuda()
                      for a in packed_batch(cfg.vocab_size))
        label = f"Llama-2-7B widths, {cfg.num_layers} layers, packed"
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    if level == "O2":
        amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return TrainStep(model, loss_fn, opt), batch, label


def main(model_name="gpt", level="O1", steps=2):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    step, batch, label = _build(model_name, level)
    tokens = batch[0].numel()
    real = int((batch[1] >= 0).sum()) if len(batch) > 1 else tokens
    for _ in range(2):
        step(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(*batch)
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) * 1e3 / 3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == cuda]
    groups, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        g = _group(e.name)
        groups[g] = groups.get(g, 0.0) + us
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    gemm_ops = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::mm", "aten::addmm", "aten::bmm"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            gemm_ops[f"{e.key} {e.input_shapes}"] = us / 1e3 / steps
    busy = _busy_us(kernels) / 1e3 / steps
    print(json.dumps({
        "phase": "train_step", "model": label, "amp": f"{level} bfloat16",
        "batch": list(batch[0].shape), "real_tokens": real,
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "wall_ms_per_step_unprofiled": unprofiled,
        "wall_ms_per_step": wall,
        "tokens_per_s_unprofiled": tokens / unprofiled * 1e3,
        "real_tokens_per_s_unprofiled": real / unprofiled * 1e3,
        "device_busy_ms_per_step": busy,
        "device_busy_share": busy / wall if wall else None,
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step": {g: t / 1e3 / steps
                               for g, t in sorted(groups.items())},
        "gemm_ops_device_ms_per_step": dict(sorted(
            gemm_ops.items(), key=lambda kv: -kv[1])),
        "top_device_ms_per_step": {n: t / 1e3 / steps for n, t in top},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("gpt", "llama_packed"),
                    default="gpt")
    ap.add_argument("--amp", choices=("O1", "O2"), default="O1")
    args = ap.parse_args()
    main(args.model, args.amp)
