"""Gradient clipping by the global norm (counterpart of paddle_tpu/nn/clip.py
ClipGradByGlobalNorm:43). Plain torch: the reference computes it in XLA."""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by clip_norm / max(global_norm, clip_norm),
    global_norm being the 2-norm of all gradients together (fp32)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def scale(self, grads):
        """The factor as a 0-d float32 tensor on the gradients' device,
        computed without a host sync."""
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads])
        global_norm = torch.linalg.vector_norm(norms)
        return self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)

    def __call__(self, params_grads):
        """[(p, g)] -> [(p, g * factor)] in each gradient's dtype."""
        if not params_grads:
            return []
        s = self.scale([g for _, g in params_grads])
        return [(p, (g.float() * s).to(g.dtype)) for p, g in params_grads]
