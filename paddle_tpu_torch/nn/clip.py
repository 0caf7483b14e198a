"""Gradient clipping by the global norm (counterpart of paddle_tpu/nn/clip.py
ClipGradByGlobalNorm:43). Plain torch: the reference computes it in XLA.
Under tensor and pipeline parallelism the norm is the global one
(grad_square_sum); under ZeRO the optimizer hands `factor` the global
square-sum, its shard's summed once over the sharding group
(optimizer/optimizers.py)."""
from __future__ import annotations

import torch


def _square_sum(grads):
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in grads])
    return norms.square().sum()


def pp_mark(p):
    """(pp group, owned) of a PipelineParallel's parameter, else None:
    owned for this rank's stage parameters, not for the tied ends and the
    loss parameters, which every stage holds alike."""
    return getattr(p, "_pp_group", None)


def _mp_square_sum(grads, params):
    """The square-sum of `grads`, the part of the parameters cut over an
    mp group summed over that group (one all-reduce a group)."""
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


def grad_square_sum(grads, params=None):
    """The fp32 sum of squares of every element of `grads`, a 0-d tensor on
    their device, computed without a host sync (one fp32-accumulating norm
    a tensor; a low-precision gradient is not copied to fp32 first).

    With `params` (`params[i]` owns `grads[i]`) it is the global
    square-sum, the same on every rank (the reference's plain clip gets it
    from GSPMD; a square-sum of this rank's gradients alone would scale
    the ranks differently):
      * tensor parallelism: the part of the parameters cut over an mp
        group is summed over that group; the whole (replicated)
        parameters, whose gradients every mp rank holds alike, count once;
      * pipeline parallelism (parameters marked by PipelineParallel,
        `pp_mark`): this rank's stage parameters' part is summed over the
        pp group; the tied ends and the loss parameters, whose gradients
        every stage holds alike after the pipeline's sum, count once."""
    if params is None:
        return _square_sum(grads)
    marks = [pp_mark(p) for p in params]
    if not any(marks):
        return _mp_square_sum(grads, params)
    from ..distributed.collective import ReduceOp, all_reduce

    group = next(m for m in marks if m)[0]
    owned = [i for i, m in enumerate(marks) if m and m[1]]
    rest = [i for i, m in enumerate(marks) if not (m and m[1])]
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)

    def part(idx):
        return _mp_square_sum([grads[i] for i in idx],
                              [params[i] for i in idx]) if idx \
            else zero.clone()
    return all_reduce(part(owned), ReduceOp.SUM, group) + part(rest)


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
