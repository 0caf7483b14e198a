"""The serving engine's graph bodies against the JAX reference's compiled
programs, on the CPU.

On a card the engine captures five kinds of body as CUDA graphs (greedy
decode steps, a sampled step, the speculative verify window, a prefill
chunk, a batched prefill) and replays them; on the CPU the same bodies run
eagerly, so these cases hold the code a card replays (the batched body's
parity with the JAX program is in tests/test_torch_serving.py):

  * host-read guard: every body runs with Tensor.item, __bool__, __int__,
    __index__, __float__, tolist, cpu and numpy and torch.cuda.synchronize
    made to raise (a host read ends a capture);
  * the sampled tick (the reference's `_decode_jit(sampled=True)`): greedy
    rows of a mixed batch equal the JAX engine's, a seeded engine repeats
    itself, temperature 1e-6 is argmax, and the sampler's draws follow
    softmax(logits / T);
  * the verify window (the reference's `_spec_jit`): greedy targets, the
    accepted prefix, the next token and the new lengths against the JAX
    program on the same window, pages and draft lengths;
  * the prefill chunk (the reference's `_prefill_jit`) with a 0-d device
    `pos`: against the host-int path and the JAX program, at pos 0, mid
    prompt, after a partial prefix hit (the lane gathered from the pool)
    and at the rope-table, wpe-table and workspace clamps; the lane covers
    every chunk window, and one prompt at most is mid-prefill.

Tiny Llama (GQA 4/2) and tiny GPT in float32, weights N(0, 0.05) made in
numpy (norms 1, biases 0) and loaded into both packages. Tolerances: tokens,
accepted counts and lengths exactly; prefill logits and K/V rows to 1e-5
(fp32 sums in another order); the sampler's total variation from the
softmax within 0.02 over 20,000 draws of a 64-way row (at these logits the
expected total variation of 20,000 exact draws is ~0.008).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_jax_state_dict)
from paddle_tpu_torch.serving import ServingEngine

ATOL = 1e-5
KW = dict(max_slots=4, block_size=8, prefill_chunk=16, max_model_len=64)
SPEC_K = 4
W = SPEC_K + 1


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


@pytest.fixture(scope="module", params=["llama", "gpt"])
def pair(request):
    return request.param, *_pair(request.param)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]


def _generate(tm, prompt, n):
    return tm.generate(torch.tensor([prompt]),
                       max_new_tokens=n)[0].tolist()[len(prompt):]


# ------------------------------------------------------- host-read guard
@contextlib.contextmanager
def no_host_reads():
    """Make every host read of a tensor (and a device synchronise) raise:
    what would end a CUDA graph capture."""
    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"host read in a graph body: {name}")
        return raiser

    with pytest.MonkeyPatch.context() as m:
        for name in ("item", "__bool__", "__int__", "__index__",
                     "__float__", "tolist", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        m.setattr(torch.cuda, "synchronize", refuse("torch.cuda.synchronize"))
        yield


def test_guard_catches_a_host_read():
    x = torch.ones(2)
    with no_host_reads():
        for read in (lambda: x.sum().item(), lambda: bool(x.any()),
                     lambda: int(x[0]), lambda: x.tolist(), lambda: x.cpu(),
                     lambda: x.numpy(), torch.cuda.synchronize):
            with pytest.raises(AssertionError, match="host read"):
                read()


def _decoding_engine(tm, temps, **kw):
    """An engine whose slots all decode (prompts prefilled, fetches
    flushed); one request a temperature."""
    eng = ServingEngine(tm, device="cpu", **{**KW, **kw})
    vocab = tm.config.vocab_size
    reqs = [eng.submit(p, max_new_tokens=40, temperature=t)
            for p, t in zip(_prompts(vocab, (9, 21, 12, 30)[:len(temps)]),
                            temps)]
    while eng.sched.waiting or eng.sched.prefilling:
        eng.step()
    eng._flush_pending()
    return eng, reqs


@pytest.mark.parametrize("body", ["decode1", "decode4", "sampled", "verify",
                                  "prefill", "batched_prefill"])
def test_graph_bodies_read_nothing_on_the_host(pair, body):
    kind, _, tm = pair
    fuse = 4 if body == "decode4" else 1
    spec_k = SPEC_K if body == "verify" else 0
    eng, reqs = _decoding_engine(tm, (0.0, 0.8, 0.0), fuse_steps=fuse,
                                 spec_k=spec_k)
    if body == "verify":
        x = eng._spec_in.host()
        x[:] = 0
        x[0, :3] = [1, 2, 3]
        x[0, W - 1] = 3
        eng._spec_in.push()
        key = ("verify", W)
    elif body == "prefill":
        # a prompt mid-prefill in the lane: its second chunk
        req = eng.submit(_prompts(tm.config.vocab_size, (40,), seed=9)[0],
                         max_new_tokens=4)
        eng.sched.admit()
        eng._prefill_one_chunk(req)
        x = eng._lane_in.host()
        x[:] = 0
        x[:16] = req.prompt[16:32]
        x[16] = 16
        eng._lane_in.push()
        key = ("prefill", 32)
    elif body == "batched_prefill":
        # two rows on null tables (their writes land in block 0)
        x = eng._bp_in.host()
        x[:] = 0
        x[0, :5] = [1, 2, 3, 4, 5]
        x[1, :9] = list(range(9))
        x[:2, 17] = [4, 8]
        eng._bp_in.push()
        key = ("batched_prefill", (16, 32))
    else:
        key = ("sampled", 1) if body == "sampled" else ("decode", fuse)
    lens = eng._d_lens.clone()
    with no_host_reads():
        eng._run(key)
    # the body did its work: live lengths advanced (prefill: none)
    moved = (eng._d_lens - lens)[eng._d_live.bool()]
    if body in ("prefill", "batched_prefill"):
        assert bool((moved == 0).all())
    else:
        assert bool((moved >= 1).all()) and int(moved.max()) <= max(fuse, W)


# --------------------------------------------------------- sampled tick
def _mixed_run(eng, prompts, temps, budget=10):
    reqs = [eng.submit(p, max_new_tokens=budget, temperature=t)
            for p, t in zip(prompts, temps)]
    eng.run_until_idle()
    return reqs


MIXED_TEMPS = (0.0, 0.8, 0.0, 1.3)


def test_sampled_ticks_keep_the_greedy_rows_of_the_jax_engine(pair):
    """A mixed batch: the greedy rows' tokens equal the JAX engine's (whose
    mixed ticks run `_decode_jit(sampled=True)`) and generate()'s, the
    sampled rows take their budget of valid tokens, and every decode tick
    with a sampled row ran the sampled body."""
    _, jm, tm = pair
    prompts = _prompts(tm.config.vocab_size, (9, 21, 12, 30), seed=4)
    eng = ServingEngine(tm, device="cpu", seed=7, **KW)
    jeng = JaxEngine(jm, **KW)
    got = _mixed_run(eng, prompts, MIXED_TEMPS)
    want = _mixed_run(jeng, prompts, MIXED_TEMPS)
    for t, g, w, p in zip(MIXED_TEMPS, got, want, prompts):
        assert len(g.output_tokens) == 10
        assert all(0 <= x < tm.config.vocab_size for x in g.output_tokens)
        if t == 0.0:
            assert g.output_tokens == w.output_tokens == _generate(tm, p, 10)
    g = eng.graph_stats()
    assert g["ticks"]["sampled"] > 0 and g["ticks"]["decode"] > 0
    assert g["replays"] == {"decode": 0, "sampled": 0, "verify": 0,
                            "prefill": 0,
                            "batched_prefill": 0}       # eager on the CPU
    assert eng.stats()["steps"] == jeng.stats()["steps"]


def test_seeded_engines_repeat_their_draws(pair):
    _, _, tm = pair
    prompts = _prompts(tm.config.vocab_size, (9, 21, 12, 30), seed=5)
    runs = [[r.output_tokens for r in _mixed_run(
        ServingEngine(tm, device="cpu", seed=s, **KW), prompts, MIXED_TEMPS)]
        for s in (11, 11, 12)]
    assert runs[0] == runs[1]
    # another seed draws other tokens on the sampled rows only
    assert runs[2] != runs[0]
    assert [runs[2][i] for i in (0, 2)] == [runs[0][i] for i in (0, 2)]


def test_temperature_near_zero_is_argmax(pair):
    _, _, tm = pair
    prompts = _prompts(tm.config.vocab_size, (9, 21), seed=6)
    eng = ServingEngine(tm, device="cpu", seed=3, **KW)
    reqs = _mixed_run(eng, prompts, (1e-6, 1e-6), budget=12)
    assert eng.graph_stats()["ticks"]["sampled"] > 0
    for r, p in zip(reqs, prompts):
        assert r.output_tokens == _generate(tm, p, 12)


@pytest.mark.parametrize("temp", [0.7, 1.0, 1.5])
def test_sampler_follows_the_softmax(temp):
    """20,000 draws of the sampler on one 64-entry row (a fixed seed)
    against softmax(logits / T); greedy rows stay argmax beside them."""
    _, tm = _pair("llama")
    eng = ServingEngine(tm, device="cpu", seed=0, **KW)
    n = 20_000
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal(64).astype(np.float32) * 2)
    temps = torch.full((n,), temp)
    temps[:100] = 0.0
    draws = eng._sample(logits.expand(n, 64).contiguous(), temps)
    assert bool((draws[:100] == torch.argmax(logits)).all())
    freq = torch.bincount(draws[100:], minlength=64).double() / (n - 100)
    p = torch.softmax(logits.double() / temp, dim=-1)
    assert 0.5 * float((freq - p).abs().sum()) <= 0.02
    # the next call draws fresh numbers from the advanced generator
    again = eng._sample(logits.expand(n, 64).contiguous(), temps)
    assert not torch.equal(again, draws)


# ---------------------------------------------------------- verify window
def _jax_dev(jeng):
    if jeng._dev is None:
        jeng._dev_init()
    return jeng._dev


@pytest.mark.parametrize("rider", [False, True])
def test_verify_body_matches_the_jax_spec_program(pair, rider):
    """From the same decoding state (both engines run the same prompts in
    lockstep), the same drafts: correct ones (generate()'s continuation,
    accepted), a wrong one (rejected after two), none; with a sampled
    rider in the last slot, drafting nothing. greedy, acc, nxt and the new
    lengths of the greedy rows equal the JAX `_spec_jit(W, sampled)`."""
    _, jm, tm = pair
    vocab = tm.config.vocab_size
    prompts = _prompts(vocab, (9, 21, 12, 30), seed=8)
    temps = (0.0, 0.0, 0.0, 0.9 if rider else 0.0)
    eng = ServingEngine(tm, device="cpu", spec_k=SPEC_K, seed=2, **KW)
    jeng = JaxEngine(jm, spec_k=SPEC_K, **KW)
    for e in (eng, jeng):
        for p, t in zip(prompts, temps):
            e.submit(p, max_new_tokens=40, temperature=t)
        while e.sched.waiting or e.sched.prefilling:
            e.step()
        e._flush_pending()
    d_toks, d_tables, d_lens, d_temps, d_seed = _jax_dev(jeng)
    toks = np.asarray(d_toks)
    win = np.zeros((KW["max_slots"], W), np.int64)
    dls = np.zeros(KW["max_slots"], np.int64)
    for (slot, req), (jslot, jreq) in zip(sorted(eng.sched.running.items()),
                                          sorted(jeng.sched.running.items())):
        assert slot == jslot and req.prompt == jreq.prompt
        win[slot, 0] = toks[slot]
        if req.temperature > 0:
            continue
        assert int(eng._d_toks[slot]) == toks[slot]
        hist = req.prompt + req.output_tokens
        right = _generate(tm, hist, SPEC_K)
        d = {0: right, 1: right[:2] + [(right[2] + 1) % vocab, 5], 2: []}.get(
            prompts.index(req.prompt), right[:3])
        win[slot, 1:1 + len(d)] = d
        dls[slot] = len(d)
    x = eng._spec_in.host()
    x[:, :W - 1] = win[:, 1:]
    x[:, W - 1] = dls
    eng._spec_in.push()
    lens = eng._d_lens.clone()
    out = eng._run(("verify", W)).clone()
    greedy, acc, nxt = out[:, :W], out[:, W], out[:, W + 1]
    jg, ja, jn, _, j_sl, _ = jeng._spec_jit(W, rider)(
        *jeng._functional()[2:], jnp.asarray(win.astype(np.int32)),
        jeng.pool.layers, d_tables, d_lens,
        jnp.asarray(dls.astype(np.int32)), d_temps, d_seed)
    jg, ja, jn, j_sl = (np.asarray(a) for a in (jg, ja, jn, j_sl))
    live = sorted(eng.sched.running)
    greedy_rows = [s for s in live if eng.sched.running[s].temperature <= 0]
    for s in greedy_rows:
        assert greedy[s].tolist() == jg[s].tolist()
        assert int(acc[s]) == ja[s] and int(nxt[s]) == jn[s]
        assert int(eng._d_lens[s]) == j_sl[s]
        assert int(eng._d_toks[s]) == int(nxt[s])
    accepted = {int(acc[s]) for s in greedy_rows}
    assert {0, 2, SPEC_K} <= accepted          # none, rejected, all taken
    for s in live:
        if eng.sched.running[s].temperature > 0:
            # the rider drafts nothing: one token, drawn from column 0
            assert int(acc[s]) == 0 and 0 <= int(nxt[s]) < vocab
            assert int(eng._d_lens[s]) == int(lens[s]) + 1


# ---------------------------------------------------------- prefill chunk
def _jax_caches(arrs):
    return [(jnp.asarray(k), jnp.asarray(v)) for k, v in arrs]


def _random_ws(tm, length, seed):
    n_layers, n_kv, hd, _ = tm._decode_geometry()
    rng = np.random.default_rng(seed)
    return [tuple((rng.standard_normal((1, length, n_kv, hd)) * 0.5)
                  .astype(np.float32) for _ in range(2))
            for _ in range(n_layers)]


def _torch_ws(arrs):
    return [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
            for k, v in arrs]


def _prefill_cases(kind):
    """(workspace length, pos): pos 0, mid prompt, and the clamps: Llama's
    rope table (128 positions) and GPT's wpe table (256), and a workspace
    too short for the window (the K/V start clamps, the mask does not)."""
    table = 128 if kind == "llama" else 256
    return [(64, 0), (64, 16), (table + 16, table - 8), (48, 40)]


def test_prefill_with_a_device_pos_matches_host_int_and_jax(pair):
    kind, jm, tm = pair
    jeng = JaxEngine(jm, **KW)
    pv, bv = jeng._functional()[2:]
    chunk = 16
    ids = np.asarray(_prompts(tm.config.vocab_size, (chunk,), seed=2),
                     np.int64)
    for length, pos in _prefill_cases(kind):
        ws = _random_ws(tm, length, seed=pos)
        with torch.no_grad():
            dev_ws, int_ws = _torch_ws(ws), _torch_ws(ws)
            lg_dev, _ = tm(torch.from_numpy(ids), caches=dev_ws,
                           pos=torch.tensor(pos))
            lg_int, _ = tm(torch.from_numpy(ids), caches=int_ws, pos=pos)
        lg_jax, j_ws = jeng._prefill_jit(chunk, length)(
            pv, bv, jnp.asarray(ids.astype(np.int32)), _jax_caches(ws),
            jnp.asarray(pos, jnp.int32))
        lg_jax = np.asarray(lg_jax)
        assert torch.isfinite(lg_dev).all()
        np.testing.assert_array_equal(lg_dev.numpy(), lg_int.numpy())
        for (dk, dv), (ik, iv) in zip(dev_ws, int_ws):
            assert torch.equal(dk, ik) and torch.equal(dv, iv)
        if kind == "gpt" and pos + chunk > 256:
            # past the wpe table the reference's take fills NaN, and 0 x NaN
            # in P.V spreads it over the chunk; the port clamps to the last
            # row (gpt.py's module note)
            assert np.isnan(lg_jax).all()
            continue
        np.testing.assert_allclose(lg_dev.numpy(), lg_jax, atol=ATOL,
                                   rtol=0)
        for (dk, dv), (jk, jv) in zip(dev_ws, j_ws):
            np.testing.assert_allclose(dk.numpy(), np.asarray(jk),
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(dv.numpy(), np.asarray(jv),
                                       atol=ATOL, rtol=0)


def test_cached_attention_device_pos_matches_the_host_int():
    """The op alone: K/V written at clamp(pos, 0, L - s) + i by index_copy_,
    the mask from the unclamped pos, as the host-int slice path."""
    from paddle_tpu_torch.ops import nn_ops

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    for L, pos in ((32, 0), (32, 9), (32, 30), (16, 12)):
        cache = rng.standard_normal((2, 1, L, 2, 16)).astype(np.float32)
        outs = []
        for p in (pos, torch.tensor(pos)):
            kc, vc = (torch.from_numpy(c.copy()) for c in cache)
            out, kc, vc = nn_ops.cached_multihead_attention(
                q, k[:, :, :2], v[:, :, :2], kc, vc, p)
            outs.append((out, kc, vc))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_prefill_lane_after_a_partial_prefix_hit_matches_jax(pair):
    """The lane seeded from pool blocks (a partial prefix hit), then the
    engine's prefill body over the next chunk, against the reference's
    `_gather_jit` + `_prefill_jit` on the same pool: the kept row's
    logits and the workspace rows the chunk leaves, to 1e-5. Stale rows
    past the prompt (from an earlier request in the lane) are masked."""
    kind, jm, tm = pair
    eng = ServingEngine(tm, device="cpu", **KW)
    jeng = JaxEngine(jm, **KW)
    rng = np.random.default_rng(5)
    pages = [tuple((rng.standard_normal(tuple(kp.shape)) * 0.5)
                   .astype(np.float32) for _ in range(2))
             for kp, _ in eng.pool.layers]
    for (kp, vp), (k, v) in zip(eng.pool.layers, pages):
        kp.copy_(torch.from_numpy(k))
        vp.copy_(torch.from_numpy(v))
    jeng.pool.replace(_jax_caches(pages))
    head = [3, 7]                       # two cached blocks: 16 tokens
    bs, chunk = KW["block_size"], KW["prefill_chunk"]
    start, plen = len(head) * bs, 16 + 11
    prompt = _prompts(tm.config.vocab_size, (plen,), seed=3)[0]
    ws = eng._lane
    for k, v in ws:                     # an earlier request's rows
        k.normal_()
        v.normal_()
    eng._gather_workspace(ws, head)
    x = eng._lane_in.host()
    x[:] = 0
    x[:plen - start] = prompt[start:]
    x[chunk] = start
    x[chunk + 1] = plen - 1 - start
    eng._lane_in.push()
    padded = start + chunk
    row = eng._run(("prefill", padded))
    j_ws = jeng._gather_jit(padded, len(head))(
        jeng.pool.layers, np.asarray(head, np.int32))
    ids = np.zeros((1, chunk), np.int32)
    ids[0, :plen - start] = prompt[start:]
    lg, j_ws = jeng._prefill_jit(chunk, padded)(
        *jeng._functional()[2:], jnp.asarray(ids), j_ws,
        jnp.asarray(start, jnp.int32))
    np.testing.assert_allclose(row.numpy(),
                               np.asarray(lg)[0, plen - 1 - start][None],
                               atol=ATOL, rtol=0)
    for (k, v), (jk, jv) in zip(ws, j_ws):
        np.testing.assert_allclose(k[0, :padded].numpy(),
                                   np.asarray(jk)[0], atol=ATOL, rtol=0)
        np.testing.assert_allclose(v[0, :padded].numpy(),
                                   np.asarray(jv)[0], atol=ATOL, rtol=0)


def test_prefill_lane_covers_every_chunk_window():
    """The lane length bounds the reference's padded workspace of every
    admissible prompt and prefix hit, so no chunk's write is clamped; it
    is the chunk multiple above the worst case, and there is one prefill
    body for each chunk multiple up to it."""
    _, tm = _pair("llama")
    for ml, chunk, bs in ((64, 16, 8), (48, 16, 8), (100, 32, 4)):
        eng = ServingEngine(tm, device="cpu", max_slots=2, block_size=bs,
                            prefill_chunk=chunk, max_model_len=ml)
        worst = max(pm + -(-(plen - pm) // chunk) * chunk
                    for plen in range(1, ml)
                    for pm in range(0, plen, bs))
        assert worst <= eng.lane_len < worst + chunk
        assert eng.lane_len % chunk == 0
        assert all(k.shape[1] == eng.lane_len for k, _ in eng._lane)
        assert sorted(size for kind, size in eng._bodies
                      if kind == "prefill") == list(
            range(chunk, eng.lane_len + 1, chunk))


def test_engine_prefill_through_the_lane_matches_jax_and_generate(pair):
    """Whole engines: chunked prompts (several chunks, a partial prefix hit
    on an earlier prompt's blocks, the lane reused by later requests) give
    the JAX engine's tokens and generate()'s; each single-prompt chunk is
    counted as a prefill tick."""
    _, jm, tm = pair
    vocab = tm.config.vocab_size
    a, b, c = _prompts(vocab, (45, 20, 33), seed=12)
    waves = [[a, b], [a[:24] + c[:9], c]]
    outs, engines = [], []
    for e in (ServingEngine(tm, device="cpu", max_slots=2, block_size=8,
                            prefill_chunk=16, max_model_len=64,
                            prefill_bucket=0),
              JaxEngine(jm, max_slots=2, block_size=8, prefill_chunk=16,
                        max_model_len=64, prefill_bucket=0)):
        reqs = []
        for wave in waves:
            reqs += [e.submit(p, max_new_tokens=6) for p in wave]
            e.run_until_idle()
        outs.append(reqs)
        engines.append(e)
    for t, j in zip(*outs):
        assert t.output_tokens == j.output_tokens == _generate(
            tm, t.prompt, 6)
    assert outs[0][2].prefix_matched == 24
    eng, jeng = engines
    assert eng.graph_stats()["ticks"]["prefill"] \
        == eng.stats()["prefill_programs"] \
        == jeng.stats()["prefill_programs"] == 3 + 2 + 1 + 3


def test_one_prompt_at_most_is_mid_prefill():
    """Prompts prefill in FCFS order and a tick stops at a prompt that is
    not done, so the lane has one owner; a second prompt starting while
    the first is mid-prefill raises."""
    _, tm = _pair("llama")
    eng = ServingEngine(tm, device="cpu", **KW)
    a, b = (eng.submit(p, max_new_tokens=3) for p in _prompts(
        tm.config.vocab_size, (40, 33), seed=1))
    eng.step()
    assert a.state == "prefill" and a.prefill_pos == 16
    assert b.state == "prefill" and b.prefill_pos == 0     # waits its turn
    with pytest.raises(RuntimeError, match="mid-prefill"):
        eng._prefill_one_chunk(b)
    eng.cancel(a)                       # the lane frees with its owner
    eng.run_until_idle()
    assert b.output_tokens == _generate(tm, b.prompt, 3)
