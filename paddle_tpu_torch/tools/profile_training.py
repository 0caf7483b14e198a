"""Where a GPT-3 1.3B training step's time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_training

Builds GPT-3 1.3B (seeded random weights, dropout 0) with AdamW
(lr 1e-4, weight decay 0.01) behind TrainStep under amp O1 (bf16), as
chip_smoke.py's train_slice phase drives it, at batch 4 x 2048. After two
warm-up steps it times 3 steps without the profiler (synchronised host
clock), then traces 2 steps with torch.profiler and prints one JSON line:
host wall time per step (with and without the profiler), device busy time
per step (the union of the kernels' intervals), the busy share, kernels per
step, device time per step by group (the port's flash forward, dQ, dK/dV
and AdamW kernels; cuBLAS GEMMs; everything else), the device time of each
GEMM by its operator and input shapes (forward and backward products
apart), and the kernels with the most device time (names cut to 80
characters). Needs one CUDA device.
"""
import json
import subprocess
import time

from .profile_serving import _busy_us

GROUPS = (("flash_fwd", ("flash_fwd_kernel",)),
          ("flash_dq", ("flash_dq_kernel",)),
          ("flash_dkv", ("flash_dkv_kernel",)),
          ("adamw", ("_adamw",)),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def _group(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(batch=4, seq=2048, steps=2):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import amp
    from ..jit import TrainStep
    from ..models import GPTConfig, GPTForCausalLM
    from ..optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.gpt3_1p3b()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    model = GPTForCausalLM(cfg, seed=0)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)

    def loss_fn(ids):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)

    step = TrainStep(model, loss_fn, opt)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    for _ in range(2):
        step(ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(ids)
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) * 1e3 / 3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids)
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
        "phase": "train_step", "model": "GPT-3 1.3B", "amp": "O1 bfloat16",
        "batch": [batch, seq],
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "wall_ms_per_step_unprofiled": unprofiled,
        "wall_ms_per_step": wall,
        "tokens_per_s_unprofiled": batch * seq / unprofiled * 1e3,
        "device_busy_ms_per_step": busy,
        "device_busy_share": busy / wall if wall else None,
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step": {g: t / 1e3 / steps
                               for g, t in sorted(groups.items())},
        "gemm_ops_device_ms_per_step": dict(sorted(
            gemm_ops.items(), key=lambda kv: -kv[1])),
        "top_device_ms_per_step": {n: t / 1e3 / steps for n, t in top},
    }), flush=True)


if __name__ == "__main__":
    main()
