"""The port's serving slice against the JAX reference, on the CPU.

LlamaConfig.tiny() (GQA 4/2) in float32, weights made by the JAX package and
carried into the port by load_jax_state_dict. The port's ServingEngine must
emit exactly the JAX ServingEngine's greedy tokens (and both the models'
generate()) over a workload that reaches every admission path: several
prefill chunks, a batched-prefill burst smaller than max_slots, a partial
prefix hit whose last chunk reaches past the rope table (the reference
clamps the table slice), a full-prompt copy-on-write hit, and more prompts
than slots so slots and blocks are reused.

Tolerance: full-sequence logits agree to 1e-4 absolute (fp32 matmuls in a
different order, ~2.5 magnitude); token streams agree exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_jax_state_dict)
from paddle_tpu_torch.serving import (BlockAllocator, EngineDrainingError,
                                      QueueFullError, ServingEngine)
from paddle_tpu_torch.core import flags as tflags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(max_slots=4, block_size=8, prefill_chunk=16)
NEW = 6


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


def _waves(vocab=512):
    """Two submission waves over one engine. Wave 1 registers the prefixes
    that wave 2 hits."""
    rng = np.random.default_rng(0)
    x = [int(t) for t in rng.integers(0, vocab, 24)]
    full16 = [int(t) for t in rng.integers(0, vocab, 16)]

    def r(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    wave1 = [r(70),            # several chunks
             r(9), r(5),       # batched-prefill burst (3 rows < 4 slots)
             x + r(5),         # registers 3 full blocks of x
             full16,           # exactly two full blocks
             r(12)]            # 6 prompts > 4 slots: slots/blocks reused
    wave2 = [x + r(98),        # partial hit (24 tokens); workspace 136 > 128
             full16,           # full-prompt hit: copy-on-write admission
             r(11)]
    return wave1, wave2


def test_load_jax_state_dict_logits_match(models):
    jm, tm = models
    ids = np.random.default_rng(1).integers(0, 512, (2, 20))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32))).numpy())
    with torch.no_grad():            # the Llama's parameters are trainable
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    bad = {k: np.zeros(1, np.float32) for k in tm.state_dict()}
    with pytest.raises(ValueError, match="shape"):
        load_jax_state_dict(tm, bad)
    with pytest.raises(ValueError, match="keys differ"):
        load_jax_state_dict(tm, {})


def test_engine_matches_jax_engine_and_generate(models):
    jm, tm = models
    wave1, wave2 = _waves()
    jeng = JaxEngine(jm, **ENGINE_KW)
    teng = ServingEngine(tm, device="cpu", **ENGINE_KW)
    for wave in (wave1, wave2):
        want = jeng.generate(wave, max_new_tokens=NEW)
        got = teng.generate(wave, max_new_tokens=NEW)
        assert got == want
        teng.allocator.check_invariants()
    # every admission path ran, in both engines alike
    st, jst = teng.stats(), jeng.stats()
    for key in ("prefill_programs", "batched_prefills", "prefill_tokens",
                "cow_admissions", "dedup_admissions"):
        assert st[key] == jst[key], key
    assert st["batched_prefills"] >= 1 and st["cow_admissions"] == 1
    assert st["kv"]["used_blocks"] == 0 and st["reserved_blocks"] == 0
    # the engine equals the static-cache generate() of both packages. Not
    # for wave2[0]: there both engines rotate the last chunk at the clamped
    # table slice (positions 112.. for tokens 120..), which generate()
    # does not do, so its tokens differ from generate()'s in both packages
    for p in wave1[:2] + wave2[2:]:
        ids = np.asarray([p], np.int32)
        t_gen = tm.generate(torch.from_numpy(ids), max_new_tokens=NEW)
        j_gen = jm.generate(paddle.to_tensor(ids), max_new_tokens=NEW)
        assert t_gen[0].tolist() == [int(t) for t in j_gen.numpy()[0]]
        assert t_gen[0].tolist() == teng.generate([p], max_new_tokens=NEW)[0]


def test_batched_prefill_row_past_the_rope_table(models):
    """A batched-prefill row whose bucket padding runs past
    max_position_embeddings: the port clamps positions as the TPU rope
    kernel does, and serves the prompt exactly as generate() does. (The
    reference's XLA fallback for the per-token rope, `_xla_packed`, fills
    NaN past the table there, and its engine's tokens for the row go
    wrong; see ROADMAP.md.)"""
    _, tm = models
    rng = np.random.default_rng(2)
    pre = [int(t) for t in rng.integers(0, 512, 112)]
    a = pre + [int(t) for t in rng.integers(0, 512, 5)]   # positions to 143
    b = [int(t) for t in rng.integers(0, 512, 20)]
    eng = ServingEngine(tm, device="cpu", max_slots=4, block_size=8,
                        prefill_chunk=32)
    eng.generate([pre + [1]], max_new_tokens=2)   # registers the prefix
    out = eng.generate([a, b], max_new_tokens=4)
    assert eng.stats()["batched_prefills"] == 1
    for p, o in zip((a, b), out):
        assert o == tm.generate(torch.tensor([p]), max_new_tokens=4)[0].tolist()


def test_dtype_cast_keeps_rope_tables_fp32():
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").to(torch.bfloat16)
    assert m._cache_dtype() == torch.bfloat16
    assert m.model._rope[0].dtype == torch.float32
    assert m.model._rope[1].dtype == torch.float32


def test_generate_sampling_and_eos(models):
    _, tm = models
    ids = torch.tensor([[1, 2, 3, 4]])
    a = tm.generate(ids, max_new_tokens=5, do_sample=True, temperature=0.8,
                    top_k=20, top_p=0.9, seed=3)
    b = tm.generate(ids, max_new_tokens=5, do_sample=True, temperature=0.8,
                    top_k=20, top_p=0.9, seed=3)
    assert a.dtype == torch.int32 and a.shape == (1, 9)
    assert torch.equal(a, b)                     # seeded
    greedy = tm.generate(ids, max_new_tokens=5)
    eos = int(greedy[0, 5])
    cut = tm.generate(ids, max_new_tokens=5, eos_token_id=eos)
    assert cut[0].tolist() == greedy[0, :6].tolist()
    eng = ServingEngine(tm, device="cpu", **ENGINE_KW)
    out = eng.generate([[1, 2, 3, 4]], max_new_tokens=5, eos_token_id=eos)
    assert out[0] == greedy[0, :6].tolist()
    req = eng.submit([5, 6, 7], max_new_tokens=4, temperature=0.7)
    eng.run_until_idle()
    assert req.finish_reason == "length" and len(req.output_tokens) == 4


def test_engine_lifecycle_and_invariants(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_slots=2, block_size=8,
                        prefill_chunk=8, num_blocks=12)
    reqs = [eng.submit(list(range(1, 20 + i)), max_new_tokens=8)
            for i in range(4)]
    eng.step()
    eng.allocator.check_invariants()
    assert eng.cancel(reqs[0]) and reqs[0].finish_reason == "cancelled"
    assert not eng.cancel(reqs[0])
    eng.drain()
    with pytest.raises(EngineDrainingError):
        eng.submit([1, 2, 3])
    assert not eng.drained()
    eng.run_until_idle()
    assert eng.drained()
    eng.resume()
    assert all(r.state == "finished" for r in reqs)
    assert all(len(r.output_tokens) == 8 for r in reqs[1:])
    eng.allocator.check_invariants()
    assert eng.stats()["kv"]["used_blocks"] == 0
    tflags.set_flags({"serving_max_queue": 1})
    try:
        eng.submit([1, 2])
        with pytest.raises(QueueFullError):
            eng.submit([3, 4])
    finally:
        tflags.set_flags({"serving_max_queue": 0})
    eng.run_until_idle()
    with pytest.raises(ValueError):
        ServingEngine(tm, device="cpu", block_size=16, prefill_chunk=8)


def test_block_allocator_prefix_cache_and_eviction():
    a = BlockAllocator(num_blocks=7, block_size=4)
    p = list(range(10))                           # 2 full blocks + 2
    t1, m1, cow1, n1 = a.reserve_prefix("a", p, 12)
    assert (m1, cow1, n1) == (0, None, 3)
    assert a.register_prefix("a", p) == 2
    t2, m2, cow2, n2 = a.reserve_prefix("b", p[:8], 10)
    # full-prompt hit: block 2 is forked, its source pinned
    assert m2 == 8 and cow2 == t1[1] and t2[0] == t1[0] and t2[1] != t1[1]
    a.check_invariants()
    a.free("a")
    a.free("b")
    a.check_invariants()
    assert a.cached_blocks == 2 and a.used_blocks == 0
    # capacity pressure evicts the cached blocks (LRU) once the free list
    # is empty
    a.reserve_prefix("c", list(range(100, 124)), 24)
    assert a.cached_blocks == 0 and a.free_blocks == 0
    assert not a.can_reserve_prefix([1], 1)
    with pytest.raises(MemoryError):
        a.reserve_prefix("d", [1], 1)
    a.free("c")
    a.check_invariants()


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(n for n in new\n"
        "                      if n.startswith('paddle_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = set(out.stdout.split())
    assert len(seen) >= 20
    # the serving front end's modules are among those walked
    for mod in ("observability.registry", "observability.spans",
                "observability.sinks", "observability.flight_recorder",
                "observability.telemetry", "observability.anomaly",
                "observability.memory", "observability.serve",
                "serving.observability", "serving.server", "serving.fleet",
                "serving.fleet_observability", "distributed.env"):
        assert "paddle_tpu_torch." + mod in seen, mod


def test_entry_points_raise_without_a_gpu(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm)
    with pytest.raises(ValueError):
        ServingEngine(tm, device="meta")


def test_batched_prefill_body_matches_the_jax_program(models):
    """The batched-prefill graph body (what a card replays) run eagerly
    against the JAX engine's `_batched_prefill_jit` on the same pages and
    inputs: a burst of three rows (two on a shared, cached 40-token prefix,
    one fresh) and a padding row, with the port at its coarser grid (S 32,
    P 128) and the reference at its own (S 24, P 64). Each row's first
    token must be equal, and the pages within 1e-5 (fp32 sums in another
    order); the blocks nobody's suffix covers keep their bytes, and the
    padding row touches only the null page. Then whole engines over a
    burst that reaches the batched call."""
    import jax.numpy as jnp

    jm, tm = models
    kw = dict(max_slots=4, block_size=8, prefill_chunk=32,
              prefill_bucket=8, max_model_len=128)
    jeng = JaxEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    assert teng._bp_S == [8, 16, 32] and teng._bp_P == [32, 64, 128, 160]
    rng = np.random.default_rng(7)
    kp0 = teng.pool.layers[0][0]
    pages = [(rng.standard_normal(kp0.shape).astype(np.float32),
              rng.standard_normal(kp0.shape).astype(np.float32))
             for _ in teng.pool.layers]
    for (kp, vp), (k, v) in zip(teng.pool.layers, pages):
        kp.copy_(torch.from_numpy(k))
        vp.copy_(torch.from_numpy(v))
    prefix = list(range(1, 6))               # 5 cached blocks = 40 tokens
    rows = [  # (offset, suffix, table)
        (40, [int(t) for t in rng.integers(0, 512, 20)],
         prefix + [6, 7, 8, 12, 13]),
        (40, [int(t) for t in rng.integers(0, 512, 5)], prefix + [9, 14]),
        (0, [int(t) for t in rng.integers(0, 512, 9)], [10, 11])]
    n, bs = kw["max_slots"], kw["block_size"]

    def host_inputs(S, P):
        nb = P // bs
        ids = np.zeros((n, S), np.int64)
        pos, last = np.zeros(n, np.int64), np.zeros(n, np.int64)
        tP = np.zeros((n, nb), np.int64)
        for r, (off, suf, table) in enumerate(rows):
            ids[r, :len(suf)] = suf
            pos[r], last[r] = off, len(suf) - 1
            tP[r, :min(nb, len(table))] = table[:nb]
        return ids, pos, last, tP

    # the reference program at (S 24, P 64)
    ids, pos, last, tP = host_inputs(24, 64)
    _, _, pv, bv = jeng._functional()
    jeng._dev_init()
    d_toks, d_bt, d_sl, d_temps, _ = jeng._dev
    bt_rows = np.zeros((n, jeng.max_blocks_per_seq), np.int32)
    for r, (_, _, table) in enumerate(rows):
        bt_rows[r, :len(table)] = table
    slots = np.array([0, 1, 2, n], np.int32)     # the padding row drops
    first_j, new_pages, *_ = jeng._batched_prefill_jit(24, 64)(
        pv, bv, [(jnp.asarray(k), jnp.asarray(v)) for k, v in pages],
        jnp.asarray(ids, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(tP, jnp.int32), jnp.asarray(last, jnp.int32),
        jnp.asarray(slots), jnp.asarray(bt_rows),
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.float32),
        d_toks, d_bt, d_sl, d_temps)
    # the port's body at (S 32, P 128), inputs through its staging
    S, P = 32, 128
    ids, pos, last, tP = host_inputs(S, P)
    x = teng._bp_in.host()
    x[:] = 0
    x[:, :S] = ids
    x[:, 32], x[:, 33] = pos, last
    x[:, 34:34 + P // bs] = tP
    teng._bp_in.push()
    first_t = teng._run(("batched_prefill", (S, P))).clone()
    assert first_t[:3].tolist() == np.asarray(first_j)[:3].tolist()
    written = {6, 7, 8, 9, 10, 11}             # the three rows' suffixes
    # the port's longer S pads into blocks 12 and 14, each its row's own
    # reservation past the prompt, which decode overwrites before it reads
    padded = {12, 14}
    for (kp, vp), (jk, jv), (k0, v0) in zip(teng.pool.layers, new_pages,
                                            pages):
        for got, want, before in ((kp.numpy(), np.asarray(jk), k0),
                                  (vp.numpy(), np.asarray(jv), v0)):
            same = [b for b in range(1, len(before)) if b not in padded]
            np.testing.assert_allclose(got[same], want[same], atol=1e-5)
            untouched = [b for b in same if b not in written]
            # the cached prefix and every other block keep their bytes
            np.testing.assert_array_equal(got[untouched], before[untouched])
    # whole engines: a burst whose rows take the batched call, on a cached
    # prefix, equals the reference engine token for token
    pre = [int(t) for t in rng.integers(0, 512, 40)]
    burst = [pre + [int(t) for t in rng.integers(0, 512, m)]
             for m in (20, 5)] + [[int(t) for t in rng.integers(0, 512, 9)]]
    for eng in (jeng, teng):
        eng.generate([pre + [3]], max_new_tokens=2)
    want = jeng.generate(burst, max_new_tokens=NEW)
    assert teng.generate(burst, max_new_tokens=NEW) == want
    assert teng.stats()["batched_prefills"] == jeng.stats()[
        "batched_prefills"] >= 1
    assert teng.graph_stats()["ticks"]["batched_prefill"] == \
        teng.stats()["batched_prefills"]


def test_batched_prefill_workspace_is_pulled_once_in_order():
    """The batched prefill's caches share one layer's buffers, so reading
    any layer but caches[0], iterating twice, or pulling fewer layers than
    the pool holds raises instead of computing against the wrong K/V."""
    from paddle_tpu_torch.serving.engine import _LayerWorkspace
    layers = [(torch.zeros(4, 2, 1, 2), torch.zeros(4, 2, 1, 2))
              for _ in range(3)]
    for li, (kp, vp) in enumerate(layers):
        kp.fill_(li + 1)
        vp.fill_(-(li + 1))
    wk = torch.empty(4, 2, 1, 2)
    idx = torch.tensor([1, 2, 3, 0])

    def ws():
        return _LayerWorkspace(layers, wk, torch.empty_like(wk), 2, 4, idx,
                               torch.tensor([1]), torch.tensor([1]))

    w = ws()
    assert w[0][0].shape == (2, 4, 1, 2)
    with pytest.raises(IndexError):
        w[1]
    seen = [float(k[0, 0, 0, 0]) for k, _ in w]
    assert seen == [1.0, 2.0, 3.0]
    w.finish()
    with pytest.raises(RuntimeError):
        list(w)
    short = ws()
    next(iter(short))
    with pytest.raises(RuntimeError):
        short.finish()
