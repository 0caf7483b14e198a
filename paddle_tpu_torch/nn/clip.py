"""Gradient clipping by the global norm (counterpart of paddle_tpu/nn/clip.py
ClipGradByGlobalNorm:43). Plain torch: the reference computes it in XLA.
Under tensor parallelism the norm is the global one (grad_square_sum);
under ZeRO the optimizer hands `factor` the global square-sum, its
shard's summed once over the sharding group (optimizer/optimizers.py)."""
from __future__ import annotations

import torch


def _square_sum(grads):
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in grads])
    return norms.square().sum()


def grad_square_sum(grads, params=None):
    """The fp32 sum of squares of every element of `grads`, a 0-d tensor on
    their device, computed without a host sync (one fp32-accumulating norm
    a tensor; a low-precision gradient is not copied to fp32 first).

    With `params` (`params[i]` owns `grads[i]`), under tensor parallelism
    it is the global square-sum, the same on every mp rank: the part of
    the parameters cut over an mp group is summed over that group, and
    the whole (replicated) parameters, whose gradients every rank holds
    alike, count once. (The reference's plain clip gets that from GSPMD;
    a square-sum of this rank's gradients alone would scale the ranks
    differently.)"""
    if params is None:
        return _square_sum(grads)
    from ..distributed.collective import ReduceOp, all_reduce
    from ..distributed.mesh import mp_group_of

    by_group = {}
    for p, g in zip(params, grads):
        by_group.setdefault(mp_group_of(p), []).append(g)
    total = None
    for group, gs in by_group.items():
        part = _square_sum(gs)
        if group is not None:
            part = all_reduce(part, ReduceOp.SUM, group)
        total = part if total is None else total + part
    return total


class ClipGradByGlobalNorm:
    """Scale every gradient by clip_norm / max(global_norm, clip_norm),
    global_norm being the 2-norm of all gradients together (fp32)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def factor(self, square_sum):
        """The factor from the gradients' fp32 square-sum (a 0-d tensor)."""
        return self.clip_norm / torch.clamp(square_sum.sqrt(),
                                            min=self.clip_norm)

    def scale(self, grads, params=None):
        """The factor as a 0-d float32 tensor on the gradients' device,
        computed without a host sync (global under tensor parallelism
        when `params` are given: grad_square_sum)."""
        return self.factor(grad_square_sum(grads, params))

    def __call__(self, params_grads):
        """[(p, g)] -> [(p, g * factor)] in each gradient's dtype."""
        if not params_grads:
            return []
        s = self.scale([g for _, g in params_grads],
                       [p for p, _ in params_grads])
        return [(p, (g.float() * s).to(g.dtype)) for p, g in params_grads]
