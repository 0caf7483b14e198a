"""The port's rotary GPT (`GPTConfig.use_rotary`) against the reference's,
on the CPU.

A tiny GPT with rotary positions (no `wpe`; q and k rotated by tables built
to max_position_embeddings) made by the JAX package in float32 and carried
into the port by load_jax_state_dict, then held against
paddle_tpu.models.GPTForCausalLM(use_rotary=True) through every branch:
the plain forward and its loss, packed rows (positions restarting at each
document), generate(), the cached forward at a 0-d device `pos` (what a
captured prefill chunk runs) against a host-int `pos`, at the table clamp
too, and the serving engine (prefill chunks, a batched burst on a cached
prefix, a copy-on-write hit, speculative windows).

Tolerances: logits and losses to 1e-4 absolute (fp32 sums in another
order, values of magnitude ~3); the device-`pos` and host-int paths of the
port to 1e-5; tokens exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_state_dict)
from paddle_tpu_torch.models.generation import init_kv_cache
from paddle_tpu_torch.serving import ServingEngine

ATOL = 1e-4
NEW = 6


def _config(pkg_config):
    cfg = pkg_config.tiny()
    cfg.use_rotary = True
    cfg.max_position_embeddings = 128
    return cfg


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = JaxGPT(_config(JaxGPTConfig))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(_config(GPTConfig), device="cpu")
    load_jax_state_dict(tm, state)
    tm.eval()
    return jm, tm, state


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 1024, shape)


def test_rotary_model_has_no_wpe_and_keeps_fp32_tables(models):
    jm, tm, state = models
    assert not any("wpe" in k for k in state)
    assert set(tm.state_dict()) == set(state)
    assert not hasattr(tm.gpt, "wpe")
    half = GPTForCausalLM(_config(GPTConfig), device="cpu").to(torch.bfloat16)
    assert half.gpt._rope[0].dtype == torch.float32
    assert half.gpt._rope[0].shape == (128, 32)


def test_forward_and_loss_match(models):
    jm, tm, _ = models
    ids = _ids(1, (2, 40))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32))).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        loss = float(tm(torch.from_numpy(ids),
                        labels=torch.from_numpy(ids)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    jloss = float(jm(paddle.to_tensor(ids.astype(np.int32)),
                     labels=paddle.to_tensor(ids.astype(np.int32))).numpy())
    assert abs(loss - jloss) < ATOL


def test_forward_past_the_positions_keeps_the_cached_table(models):
    """A plain forward longer than max_position_embeddings rotates with a
    longer table, as the reference's grows, and leaves the table the
    cached paths (and their captured graphs) read where it was."""
    jm, tm, _ = models
    table = tm.gpt._rope[0]
    ptr = table.data_ptr()
    ids = _ids(9, (1, 160))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32))).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert tm.gpt._rope[0] is table and table.data_ptr() == ptr
    assert table.shape[0] == 128


def test_packed_rows_match(models):
    """Two rows of packed documents (a -1 padding tail): positions restart
    at every document, as the reference's packed RoPE does."""
    jm, tm, _ = models
    ids = _ids(2, (2, 48))
    seg = np.array([[0] * 20 + [1] * 16 + [2] * 12,
                    [0] * 30 + [1] * 10 + [-1] * 8], np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)),
                         segments=paddle.to_tensor(seg)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), segments=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    # a packed document equals the same document alone
    with torch.no_grad():
        alone = tm(torch.from_numpy(ids[:1, 20:36]))
    np.testing.assert_allclose(got[0, 20:36].numpy(), alone[0].numpy(),
                               atol=1e-5)


def test_generate_matches(models):
    jm, tm, _ = models
    for n in (3, 17, 40):
        p = _ids(3 + n, (1, n))
        got = tm.generate(torch.from_numpy(p), max_new_tokens=NEW)
        want = jm.generate(paddle.to_tensor(p.astype(np.int32)),
                           max_new_tokens=NEW)
        assert got[0].tolist() == [int(t) for t in want.numpy()[0]]


@pytest.mark.parametrize("pos", [0, 20, 120])
def test_device_pos_matches_the_host_int_pos(models, pos):
    """The cached forward at a 0-d device `pos` (a captured prefill chunk)
    against a host-int `pos` on the same cache: rotated per token, at the
    table slice clamp(pos, 0, P - s) as lax.dynamic_slice clamps (pos 120
    with 16 tokens runs past the 128-row table)."""
    _, tm, _ = models
    cfg = tm.config
    rng = np.random.default_rng(pos)
    ids = torch.from_numpy(rng.integers(0, 1024, (1, 16)))
    base = init_kv_cache(1, 144, cfg.num_layers, cfg.num_heads,
                         cfg.hidden_size // cfg.num_heads, torch.float32,
                         torch.device("cpu"))
    for k, v in base:
        k.copy_(torch.from_numpy(rng.standard_normal(k.shape)
                                 .astype(np.float32)))
        v.copy_(torch.from_numpy(rng.standard_normal(v.shape)
                                 .astype(np.float32)))
    outs = []
    for p in (pos, torch.tensor(pos)):
        caches = [(k.clone(), v.clone()) for k, v in base]
        with torch.no_grad():
            lg, ncs = tm(ids, caches=caches, pos=p)
        outs.append((lg, ncs))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(),
                               atol=1e-5)
    for (k0, v0), (k1, v1) in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(k0.numpy(), k1.numpy(), atol=1e-5)
        np.testing.assert_allclose(v0.numpy(), v1.numpy(), atol=1e-5)


def test_the_rope_kernel_gets_contiguous_q_and_k(models, monkeypatch):
    """GPT's q and k are strided views of its fused projection; the CUDA
    RoPE kernel takes contiguous tensors only, so the ops hand it copies:
    every path's call must arrive contiguous (on the CPU the plain version
    would take any layout and hide it)."""
    from paddle_tpu_torch.ops import nn_ops

    _, tm, _ = models
    seen = []
    for name in ("fused_rope", "fused_rope_packed"):
        real = getattr(nn_ops, name)

        def check(q, k, *rest, real=real, name=name):
            seen.append(name)
            assert q.is_contiguous() and k.is_contiguous(), name
            return real(q, k, *rest)

        monkeypatch.setattr(nn_ops, name, check)
    ids = torch.from_numpy(_ids(9, (2, 24)))
    seg = torch.tensor([[0] * 10 + [1] * 14] * 2, dtype=torch.int32)
    with torch.no_grad():
        tm(ids)
        tm(ids, segments=seg)
    tm.generate(ids[:1, :8], max_new_tokens=3)
    ServingEngine(tm, device="cpu", max_slots=2, block_size=8,
                  prefill_chunk=16).generate([ids[0].tolist()],
                                             max_new_tokens=3)
    assert {"fused_rope", "fused_rope_packed"} <= set(seen)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_matches_the_jax_engine_and_generate(models, spec_k):
    """Prefill chunks, a batched burst on a cached prefix, a copy-on-write
    hit and more prompts than slots, with and without speculation."""
    jm, tm, _ = models
    kw = dict(max_slots=4, block_size=8, prefill_chunk=16, spec_k=spec_k)
    rng = np.random.default_rng(11)

    def r(n):
        return [int(t) for t in rng.integers(0, 1024, n)]

    pre = r(24)
    pat = r(6)
    wave1 = [r(45), r(9), r(5), pre + r(3), pat * 5, r(16)]
    wave2 = [pre + r(7), pre + r(2), list(wave1[5]), r(11)]
    jeng = JaxEngine(jm, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    for wave in (wave1, wave2):
        want = jeng.generate(wave, max_new_tokens=NEW)
        assert teng.generate(wave, max_new_tokens=NEW) == want
    st, jst = teng.stats(), jeng.stats()
    for key in ("prefill_programs", "batched_prefills", "prefill_tokens",
                "cow_admissions"):
        assert st[key] == jst[key], key
    assert st["batched_prefills"] >= 2 and st["cow_admissions"] == 1
    for p in wave1[:3]:
        g = tm.generate(torch.tensor([p]), max_new_tokens=NEW)[0].tolist()
        assert g == teng.generate([p], max_new_tokens=NEW)[0]
