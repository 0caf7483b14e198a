"""Gradient clipping by the global norm (counterpart of paddle_tpu/nn/clip.py
ClipGradByGlobalNorm:43). Plain torch: the reference computes it in XLA."""
from __future__ import annotations

import torch


def grad_square_sum(grads):
    """The fp32 sum of squares of every element of `grads`, a 0-d tensor on
    their device, computed without a host sync (one fp32-accumulating norm
    a tensor; a low-precision gradient is not copied to fp32 first)."""
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in grads])
    return norms.square().sum()


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

    def scale(self, grads):
        """The factor as a 0-d float32 tensor on the gradients' device,
        computed without a host sync."""
        return self.factor(grad_square_sum(grads))

    def __call__(self, params_grads):
        """[(p, g)] -> [(p, g * factor)] in each gradient's dtype."""
        if not params_grads:
            return []
        s = self.scale([g for _, g in params_grads])
        return [(p, (g.float() * s).to(g.dtype)) for p, g in params_grads]
