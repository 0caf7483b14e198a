"""The port's flash attention against the JAX reference, on the CPU.

paddle_tpu_torch/ops/gpu/flash_attention.py holds three CUDA kernels (the
forward, dQ and dK/dV), their plain PyTorch versions and the autograd
Function that joins them; on CPU tensors the Function runs the plain
versions. These tests hold the forward and the gradients it gives against
the reference's Pallas kernels in interpret mode (`flash_attention(...,
interpret=True)` and its `jax.vjp`) and against its XLA pair `_dense_fwd` /
`_dense_bwd`, on the same numpy inputs. The CUDA kernels are held against
the same plain versions on the card by chip_smoke.py.

Tolerances: float32 to 1e-5 of the value plus 1e-5 of the output's RMS
(both sides do the same fp32 arithmetic in another order); bfloat16 to one
bf16 rounding (2**-7) of the value plus one of the output's RMS: both sides
round the same fp32 result once, and in the backward each side forms
delta = rowsum(dO * O) from its own rounded O, so one rounding of O enters
the gradients at the scale of their RMS.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import nn_ops as jops
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.ops.gpu import flash_attention as tflash

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

DTYPES = [("f32", jnp.float32, torch.float32),
          ("bf16", jnp.bfloat16, torch.bfloat16)]
# (b, sq, sk, h, d, causal)
SHAPES = [(2, 128, 128, 2, 32, True), (1, 256, 256, 2, 64, True),
          (2, 256, 256, 2, 32, False), (1, 128, 256, 2, 64, False)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tdt):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    tol = 1e-5 if tdt == torch.float32 else 2.0 ** -7
    err = np.abs(got - want)
    assert (err <= tol * (np.abs(want) + rms)).all(), \
        (err.max(), rms)


def _inputs(shape, jdt, tdt, seed=0):
    b, sq, sk, h, d, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, n, h, d)).astype(np.float32)
            for n in (sq, sk, sk, sq)]
    jax_in = [jnp.asarray(a).astype(jdt) for a in arrs]
    torch_in = [torch.from_numpy(a.copy()).to(tdt) for a in arrs]
    return jax_in, torch_in


@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "b{}-sq{}-sk{}-h{}-d{}-{}".format(
                             *s[:5], "causal" if s[5] else "full"))
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
def test_flash_plain_matches_pallas_and_dense(shape, dt):
    _, jdt, tdt = dt
    causal = shape[5]
    scale = shape[4] ** -0.5
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(shape, jdt, tdt)

    # port: forward and backward through the autograd Function (CPU: plain)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = tflash.flash_attention(q, k, v, scale, causal)
    o.backward(do)
    _, lse = tflash.flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                    scale, causal)
    assert o.dtype == tdt and q.grad.dtype == tdt

    # the Pallas kernels in interpret mode, and their VJP
    def pallas(a, b_, c):
        return jflash.flash_attention(a, b_, c, scale, causal, 128, 128,
                                      True)

    po, vjp = jax.vjp(pallas, jq, jk, jv)
    pdq, pdk, pdv = vjp(jdo)
    _, (_, _, _, _, plse) = jflash._fwd(jq, jk, jv, scale, causal, 128, 128,
                                        True)
    # the XLA pair
    xo, res = jflash._dense_fwd(jq, jk, jv, scale, causal)
    xdq, xdk, xdv = jflash._dense_bwd(scale, causal, res, jdo)

    for want_o, want_lse, grads in ((po, plse, (pdq, pdk, pdv)),
                                    (xo, res[4], (xdq, xdk, xdv))):
        _close(o, want_o, tdt)
        _close(lse, np.asarray(want_lse)[..., 0], torch.float32)
        for got, want in zip((q.grad, k.grad, v.grad), grads):
            _close(got, want, tdt)


def test_gate_matches_the_reference():
    """The port's supports() is the reference's, head_dim gate included."""
    cases = []
    for sq, sk in ((128, 128), (256, 128), (128, 256), (100, 100),
                   (64, 64), (384, 384), (128, 200)):
        for d in (32, 64, 128, 200, 256, 288):
            for causal in (False, True):
                cases.append(((2, sq, 4, d), (2, sk, 4, d), None, 0.0,
                              causal))
    cases += [((1, 128, 2, 64), (1, 128, 2, 64), np.ones((1, 1, 128, 128)),
               0.0, False),
              ((1, 128, 2, 64), (1, 128, 2, 64), None, 0.1, True)]
    for qs, ks, mask, p, causal in cases:
        assert tflash.supports(qs, ks, mask, p, causal) == \
            jflash.supports(qs, ks, mask, p, causal), (qs, ks, causal)


def _sdpa_pair(shape, causal, seed=1):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(shape + (causal,), jnp.float32,
                                            torch.float32, seed)
    want = jops.scaled_dot_product_attention(jq, jk, jv, is_causal=causal)
    got = tops.scaled_dot_product_attention(q, k, v, is_causal=causal)
    return got, want


def test_sdpa_dispatch_takes_flash_where_the_reference_does(monkeypatch):
    calls = []
    real = tflash.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention", counted)
    # admitted: flash in both packages
    got, want = _sdpa_pair((1, 128, 128, 2, 32), True)
    assert len(calls) == 1
    _close(got, want, torch.float32)
    # s = 100 is rejected by both gates: the _sdpa_xla composition in both
    assert not tflash.supports((1, 100, 2, 32), (1, 100, 2, 32), None, 0.0,
                               True)
    got, want = _sdpa_pair((1, 100, 100, 2, 32), True)
    assert len(calls) == 1
    _close(got, want, torch.float32)
    (jq, jk, jv, _), _ = _inputs((1, 100, 100, 2, 32, True), jnp.float32,
                                 torch.float32, 1)
    _close(got, jops._sdpa_xla(jq, jk, jv, None, 0.0, True, True,
                               32 ** -0.5), torch.float32)
    # the flag switches flash off
    tflags.set_flags({"use_flash_attention": False})
    try:
        got, want = _sdpa_pair((1, 128, 128, 2, 32), True)
    finally:
        tflags.set_flags({"use_flash_attention": True})
    assert len(calls) == 1
    _close(got, want, torch.float32)


def test_flash_wrappers_check_their_inputs():
    q = torch.zeros(1, 128, 2, 300)
    with pytest.raises(ValueError, match="head_dim"):
        tflash._check(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash._check(q[..., :64].half(), q[..., :64].half(),
                      q[..., :64].half())
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 128, 2, 192)[..., :64]
        tflash._check(x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        tflash.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"), 1.0,
                         False)
