"""The port's fused greedy decode, deferred token fetch, prefill-only
requests and KV-block wire against the JAX reference, on the CPU.

Tiny Llama (GQA 4/2) and tiny GPT in float32, with seeded weights made in
numpy and loaded into both packages. On the CPU the port's engine runs its
k-step greedy body eagerly (the body a CUDA graph captures on a card), so
these cases hold the graph's semantics against the reference's
`_decode_multi_jit` (FLAGS_serving_fuse_steps).

Tolerances: token streams agree exactly; KV wire records are compared as
bytes, exactly.

One deliberate divergence: at fuse_steps > 1 the reference appends the
tokens a fused chunk computes past max_model_len (a request whose context
reaches the cap mid-chunk gets up to k - 1 extra tokens, which
fuse_steps=1 and generate() never give). The port drops them at flush, so
its output is the reference's cut at the cap; the case below pins both.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import flags as jflags
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import BlockAllocator as JaxAllocator
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_jax_state_dict)
from paddle_tpu_torch.serving import BlockAllocator, ServingEngine

MAX_LEN = 48
KW = dict(max_slots=4, block_size=8, prefill_chunk=16, max_model_len=MAX_LEN)


def _np_state(jax_model, seed=3, std=0.05):
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in jax_model.state_dict().items():
        shape = tuple(v.shape)
        if name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif len(shape) == 1:                    # norm weights
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def _pair(kind):
    if kind == "gpt":
        jm, tm = JaxGPT(JaxGPTConfig.tiny()), GPTForCausalLM(
            GPTConfig.tiny(), device="cpu")
    else:
        jm, tm = JaxLlama(JaxLlamaConfig.tiny()), LlamaForCausalLM(
            LlamaConfig.tiny(), device="cpu")
    jm.eval()
    state = _np_state(jm)
    jm.set_state_dict(state)
    load_jax_state_dict(tm, state)
    return jm, tm


def _jax_engine(jm, fuse, **kw):
    old = jflags.get_flag("serving_fuse_steps")
    jflags.set_flags({"serving_fuse_steps": fuse})
    try:
        return JaxEngine(jm, **{**KW, **kw})
    finally:
        jflags.set_flags({"serving_fuse_steps": old})


def _generate(tm, prompt, n, eos=None):
    out = tm.generate(torch.tensor([prompt]), max_new_tokens=n,
                      eos_token_id=eos)[0].tolist()[len(prompt):]
    return out[:out.index(eos) + 1] if eos in out else out


def _workload(tm):
    """Two waves, (prompt, budget, eos) each. Wave 1: budgets 6, 7 and 9
    (not multiples of 4), an eos that greedy emits as its third token
    (inside the first fused chunk), and a prompt that registers a 16-token
    prefix. Wave 2 shares that prefix twice: one request runs into
    max_model_len mid-chunk while the other decodes beside it."""
    vocab = tm.config.vocab_size
    rng = np.random.default_rng(0)

    def r(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    shared = r(16)
    eos_prompt, eos = None, None
    while eos is None:
        p = r(11)
        g = _generate(tm, p, 3)
        if g[2] not in g[:2]:
            eos_prompt, eos = p, g[2]
    wave1 = [(r(9), 6, None), (r(21), 7, None), (eos_prompt, 12, eos),
             (shared + r(3), 9, None)]
    wave2 = [(shared + r(11), 60, None), (shared + r(5), 9, None)]
    return wave1, wave2


def _run(eng, waves):
    reqs = []
    for wave in waves:
        reqs += [eng.submit(p, max_new_tokens=n, eos_token_id=e)
                 for p, n, e in wave]
        eng.run_until_idle()
    return reqs


@pytest.fixture(scope="module", params=["llama", "gpt"])
def runs(request):
    """The workload through the JAX engine at FLAGS_serving_fuse_steps=4
    and the port's engines at fuse_steps 4 and 1 (one build a model)."""
    jm, tm = _pair(request.param)
    waves = _workload(tm)
    jeng = _jax_engine(jm, 4)
    teng = ServingEngine(tm, device="cpu", fuse_steps=4, **KW)
    one = ServingEngine(tm, device="cpu", fuse_steps=1, **KW)
    return dict(kind=request.param, jm=jm, tm=tm, waves=waves, jeng=jeng,
                teng=teng, jreqs=_run(jeng, waves), treqs=_run(teng, waves),
                ones=_run(one, waves))


def test_fuse4_matches_jax_engine_fuse1_and_generate(runs):
    tm, waves = runs["tm"], runs["waves"]
    items = [x for w in waves for x in w]
    for (p, n, eos), t, j, o in zip(items, runs["treqs"], runs["jreqs"],
                                    runs["ones"]):
        cap = min(n, MAX_LEN - len(p) + 1)
        want = _generate(tm, p, cap, eos)
        assert t.output_tokens == want
        assert o.output_tokens == want
        assert t.finish_reason == o.finish_reason == j.finish_reason
        # the reference's fused chunk overshoots max_model_len (module
        # note); up to the cap it agrees token for token
        assert j.output_tokens[:len(want)] == want
        if n > cap:
            assert len(want) < len(j.output_tokens) <= len(want) + 3
        else:
            assert j.output_tokens == want
    # the cases the workload is meant to reach
    reasons = [t.finish_reason for t in runs["treqs"]]
    assert reasons.count("stop") == 1
    assert runs["treqs"][2].output_tokens[-1] == items[2][2]
    long = runs["treqs"][4]
    assert len(long.prompt) + len(long.output_tokens) == MAX_LEN + 1
    assert runs["treqs"][5].prefix_matched == 16
    # both engines took the same admission paths in the same ticks
    st, jst = runs["teng"].stats(), runs["jeng"].stats()
    for key in ("steps", "prefill_programs", "batched_prefills",
                "prefill_tokens", "cow_admissions", "dedup_admissions"):
        assert st[key] == jst[key], key
    assert st["kv"]["used_blocks"] == 0
    runs["teng"].allocator.check_invariants()


def _shape(x):
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    return "number" if isinstance(x, (int, float)) and not isinstance(
        x, bool) else type(x).__name__


def test_stats_have_the_reference_shape(runs):
    assert _shape(runs["teng"].stats()) == _shape(runs["jeng"].stats())


def test_fuse_steps_and_speculation_exclude_each_other(runs):
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(runs["tm"], device="cpu", fuse_steps=4, spec_k=4,
                      **KW)
    old = jflags.get_flag("serving_fuse_steps")
    jflags.set_flags({"serving_fuse_steps": 4})
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            JaxEngine(runs["jm"], spec_k=4, **KW)
    finally:
        jflags.set_flags({"serving_fuse_steps": old})
    with pytest.raises(ValueError):
        ServingEngine(runs["tm"], device="cpu", fuse_steps=0, **KW)


def test_deferred_fetch_flushes_when_a_value_matters(runs):
    """Greedy tokens stay on the device between flushes; a request with an
    eos id flushes every tick."""
    eng = ServingEngine(runs["tm"], device="cpu", fuse_steps=4, **KW)
    plain = eng.submit(list(range(1, 12)), max_new_tokens=30)
    eng.step()              # prefill (first token deferred) + 4 steps
    assert plain.output_tokens == [] and plain._pending_n == 5
    eng.step()
    assert plain.output_tokens == [] and plain._pending_n == 9
    watched = eng.submit(list(range(20, 31)), max_new_tokens=30,
                         eos_token_id=-1)
    eng.step()                        # an eos holder joins: flush
    assert len(plain.output_tokens) == 13 and plain._pending_n == 0
    assert len(watched.output_tokens) == 5
    eng.run_until_idle()
    assert len(plain.output_tokens) == 30 == len(watched.output_tokens)


# ------------------------------------------------------ prefill_only
def test_prefill_only_keeps_indexed_blocks(runs):
    jm, tm = runs["jm"], runs["tm"]
    prompt = [int(t) for t in np.random.default_rng(5).integers(
        0, tm.config.vocab_size, 21)]
    jeng = _jax_engine(jm, 1)
    teng = ServingEngine(tm, device="cpu", **KW)
    for eng in (jeng, teng):
        req = eng.submit(prompt, max_new_tokens=8, prefill_only=True)
        eng.run_until_idle()
        assert req.finish_reason == "prefill_complete"
        assert req.output_tokens == []
        assert eng.allocator.peek_match(prompt) == 16   # 2 full blocks
        assert eng.stats()["kv"]["cached_blocks"] == 2
        # a repeat is a full-prompt hit: finishes without prefill
        before = eng.prefill_tokens
        again = eng.submit(prompt[:16], prefill_only=True)
        eng.run_until_idle()
        assert again.finish_reason == "prefill_complete"
        assert eng.prefill_tokens == before
    # a batched prefill row can be prefill_only too
    rows = [teng.submit(prompt[:5], prefill_only=True),
            teng.submit(prompt[5:14], max_new_tokens=3)]
    teng.run_until_idle()
    assert teng.batched_prefills == 1
    assert rows[0].finish_reason == "prefill_complete"
    assert rows[1].output_tokens == _generate(tm, prompt[5:14], 3)
    teng.allocator.check_invariants()


# --------------------------------------------------------- the KV wire
def _chained(cls, tokens, bs=4):
    a = cls(num_blocks=16, block_size=bs)
    a.reserve_prefix("seq", tokens, len(tokens))
    a.register_prefix("seq", tokens)
    return a


def test_export_prefix_and_import_block_match_the_jax_allocator():
    tokens = list(range(100, 112))               # 3 full blocks of 4
    mine = _chained(BlockAllocator, tokens).export_prefix(tokens)
    ref = _chained(JaxAllocator, tokens).export_prefix(tokens)
    assert mine == ref
    assert [r["prev"] for r in mine] == [b""] + [r["digest"]
                                                 for r in mine[:-1]]
    for src, cls in ((ref, BlockAllocator), (mine, JaxAllocator)):
        b = cls(num_blocks=16, block_size=4)
        first = [b.import_block(r["prev"], r["tokens"], r["digest"])
                 for r in src]
        again = [b.import_block(r["prev"], r["tokens"], r["digest"])
                 for r in src]
        assert all(imp for _, imp in first)
        assert again == [(blk, False) for blk, _ in first]
        b.check_invariants()
        assert b.peek_match(tokens) == 12
        assert b.blocks_needed(tokens, 16) == 2   # 4 total, 3 hit, +1 fork
        assert b.can_allocate(4 * 15) and not b.can_allocate(4 * 16)
    b = BlockAllocator(num_blocks=16, block_size=4)
    free = b.free_blocks
    with pytest.raises(ValueError):
        b.import_block(ref[0]["prev"], [t + 1 for t in ref[0]["tokens"]],
                       ref[0]["digest"])
    with pytest.raises(ValueError):
        b.import_block(ref[1]["prev"], ref[1]["tokens"], ref[0]["digest"])
    assert b.free_blocks == free
    b.check_invariants()


def _records_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert {k: ra[k] for k in ("digest", "prev", "tokens")} == \
            {k: rb[k] for k in ("digest", "prev", "tokens")}
        assert [(bytes(k), bytes(v)) for k, v in ra["layers"]] == \
            [(bytes(k), bytes(v)) for k, v in rb["layers"]]


def test_kv_wire_round_trips_between_the_packages(runs):
    jm, tm = runs["jm"], runs["tm"]
    prompt = [int(t) for t in np.random.default_rng(7).integers(
        0, tm.config.vocab_size, 24)]
    ja = _jax_engine(jm, 1)
    want = ja.generate([prompt], max_new_tokens=5)[0]
    jrecs = ja.export_kv_blocks(prompt)
    assert len(jrecs) == 3
    # the JAX engine's blocks into the port: verified, written in place,
    # re-exported as the same bytes, then a full prefix hit that decodes
    # as the reference does
    tb = ServingEngine(tm, device="cpu", **KW)
    st = tb.ingest_kv_blocks(jrecs)
    n_layers = tm.config.num_layers
    blk_bytes = tb.pool.layers[0][0][0].numel() * 4
    assert st == {"imported": 3, "dedup": 0, "rejected": 0, "skipped": 0,
                  "bytes": 3 * 2 * n_layers * blk_bytes}
    _records_equal(tb.export_kv_blocks(prompt), jrecs)
    req = tb.submit(prompt, max_new_tokens=5)
    tb.run_until_idle()
    assert req.prefix_matched == len(prompt) and tb.prefill_tokens == 0
    assert prompt + req.output_tokens == want
    assert tb.ingest_kv_blocks(jrecs)["dedup"] == 3        # idempotent
    # the port's blocks into the JAX engine, bytes unchanged
    ta = ServingEngine(tm, device="cpu", **KW)
    ta.generate([prompt], max_new_tokens=2)
    trecs = ta.export_kv_blocks(prompt)
    jb = _jax_engine(jm, 1)
    assert jb.ingest_kv_blocks(trecs)["imported"] == 3
    _records_equal(jb.export_kv_blocks(prompt), trecs)
    # a corrupt link stops the chain; its verified head stays
    bad = [dict(r) for r in jrecs]
    bad[1]["tokens"] = [(t + 1) % tm.config.vocab_size
                        for t in bad[1]["tokens"]]
    tc = ServingEngine(tm, device="cpu", **KW)
    assert tc.ingest_kv_blocks(bad) == dict(
        imported=1, dedup=0, rejected=1, skipped=1, bytes=st["bytes"] // 3)
    short = [dict(jrecs[0], layers=[(k[:-2], v) for k, v in
                                    jrecs[0]["layers"]])]
    assert tc.ingest_kv_blocks(short) == dict(
        imported=0, dedup=0, rejected=1, skipped=0, bytes=0)
    assert tc.allocator.conservation_ok()
    st2 = tc.ingest_kv_blocks(jrecs)
    assert (st2["imported"], st2["dedup"], st2["rejected"]) == (2, 1, 0)


def test_bf16_pages_export_the_reference_bytes(runs):
    """A bf16 page exported by the port carries the bits the reference's
    numpy export of the same page writes (jnp bfloat16 .tobytes())."""
    tm = copy.deepcopy(runs["tm"]).to(torch.bfloat16)
    eng = ServingEngine(tm, device="cpu", **KW)
    prompt = list(range(1, 17))
    eng.submit(prompt, prefill_only=True)
    eng.run_until_idle()
    recs = eng.export_kv_blocks(prompt)
    assert len(recs) == 2
    for r in recs:
        blk = eng.allocator._index[bytes.fromhex(r["digest"])]
        for (kb, vb), (kp, vp) in zip(r["layers"], eng.pool.layers):
            for got, page in ((kb, kp[blk]), (vb, vp[blk])):
                # bf16 -> fp32 is exact, so the reference's bf16 array of
                # these values holds the page's bits
                ref = np.asarray(jnp.asarray(
                    page.float().numpy()).astype(jnp.bfloat16))
                assert got == ref.tobytes()
    other = ServingEngine(tm, device="cpu", **KW)
    assert other.ingest_kv_blocks(recs)["imported"] == 2
    _records_equal(other.export_kv_blocks(prompt), recs)
