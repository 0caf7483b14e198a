"""Activation recomputation (counterpart of
paddle_tpu/distributed/fleet/recompute.py).

`recompute(function, *args)` runs the function keeping none of its
intermediate activations; the backward pass runs it again to get them. The
reference wraps the segment in `jax.checkpoint`; the port uses
`torch.utils.checkpoint` in its non-reentrant form, which keeps the
autograd graph as it is (the same backward nodes in the same order, so
gradients accumulate as without recompute) and only repacks what the
forward saves. `use_reentrant` is accepted and ignored: the reference
ignores it too.

Two pieces of state the recomputation must see as the first forward did,
which torch.utils.checkpoint does not restore:

  * amp. The port's `auto_cast` is its own thread-local state
    (amp/state.py), not torch.autocast. TrainStep calls backward() after
    the loss function has left `auto_cast`, and on a card the autograd
    engine runs the backward on its own device thread, where the state is
    the default one. So `recompute` snapshots the amp state (enabled,
    dtype, level, custom lists) at the forward and re-enters it around the
    recomputation. The port's flags are process-global and need nothing.
  * RNG. Dropout draws from the models' explicit torch.Generators
    (nn/layers.py Dropout); torch.utils.checkpoint's `preserve_rng_state`
    covers only torch's default generators. With `preserve_rng_state` the
    states of every generator the segment's modules hold are saved at the
    forward, set before the recomputation and put back after it, so the
    recomputed masks are the first ones (the reference gets this by
    construction, recompute.py:11-14), and torch's default generators are
    left to torch.utils.checkpoint.

`policy` is the reference's name for what may be kept (recompute.py:31-39):
None, "full" and "nothing_saveable" recompute everything; "dots_saveable"
keeps the outputs of the matrix products (mm, addmm, bmm, baddbmm) and
"dots_with_no_batch_dims_saveable" those without a batch dimension (mm,
addmm), through torch.utils.checkpoint's selective checkpointing;
"everything_saveable" keeps everything, which is the plain call. The
port's CUDA kernels launch through ctypes inside autograd Functions and
are invisible to the dispatcher that selective checkpointing watches: they
run again in every recomputation, and the ops that allocate their outputs
replay in the same order, so the policy's matching of ops is unchanged. An
unknown policy raises ValueError, as the reference's does.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.utils.checkpoint as _ckpt

from ...amp.state import amp_state
from ...nn.layers import module_generators

__all__ = ["recompute", "recompute_sequential"]

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default)
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)

# policy name -> ops whose outputs are kept; None = recompute everything,
# "all" = keep everything (no checkpoint)
_POLICIES = {
    None: None,
    "full": None,
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "nothing_saveable": None,
    "everything_saveable": "all",
}

_AMP_FIELDS = ("enabled", "dtype", "level", "custom_white", "custom_black")


def _selective(keep):
    def policy_fn(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in keep
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                             policy_fn)


def recompute(function: Callable, *args, policy: Optional[str] = None,
              preserve_rng_state: bool = True, use_reentrant: bool = True,
              **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its intermediate
    activations; they are recomputed during backward (see the module
    note)."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown recompute policy {policy!r}; "
                         f"one of {sorted(k for k in _POLICIES if k)}")
    keep = _POLICIES[policy]
    if keep == "all":
        return function(*args, **kwargs)
    st = amp_state()
    amp_at_forward = tuple(getattr(st, f) for f in _AMP_FIELDS)
    gens = module_generators(function) if preserve_rng_state else []
    rng_at_forward = [g.get_state() for g in gens]
    calls = [0]

    def run(*a, **k):
        st = amp_state()   # the recomputing thread's own
        prev_amp = tuple(getattr(st, f) for f in _AMP_FIELDS)
        first = calls[0] == 0
        calls[0] += 1
        prev_rng = [] if first else [g.get_state() for g in gens]
        for f, v in zip(_AMP_FIELDS, amp_at_forward):
            setattr(st, f, v)
        if not first:
            for g, s in zip(gens, rng_at_forward):
                g.set_state(s)
        try:
            return function(*a, **k)
        finally:
            for f, v in zip(_AMP_FIELDS, prev_amp):
                setattr(st, f, v)
            for g, s in zip(gens, prev_rng):
                g.set_state(s)

    extra = {} if keep is None else {"context_fn": _selective(keep)}
    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state,
                            **extra, **kwargs)


class _Chunk(torch.nn.Module):
    """A run of layers applied in order, each on the previous one's
    output (a tuple is unpacked into the next layer's arguments)."""

    def __init__(self, mods):
        super().__init__()
        self.mods = torch.nn.ModuleList(mods)

    def forward(self, *xs):
        for m in self.mods:
            xs = m(*xs) if isinstance(xs, tuple) else m(xs)
            if not isinstance(xs, tuple):
                xs = (xs,)
        return xs if len(xs) > 1 else xs[0]


def recompute_sequential(ctx: Optional[dict], functions, *args, **kwargs):
    """The reference's recompute_sequential: run a sequence of layers in
    `ctx["segments"]` chunks, each chunk recomputed (with
    `ctx["policy"]`)."""
    ctx = ctx or {}
    segments = ctx.get("segments", 1)
    policy = ctx.get("policy", None)
    layers = list(functions)
    n = len(layers)
    per = (n + segments - 1) // segments
    out = args
    for s in range(0, n, per):
        out = recompute(_Chunk(layers[s:s + per]),
                        *(out if isinstance(out, tuple) else (out,)),
                        policy=policy, **kwargs)
        if not isinstance(out, tuple):
            out = (out,)
    return out if len(out) > 1 else out[0]
