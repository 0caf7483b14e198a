"""HybridParallelOptimizer (counterpart of paddle_tpu/distributed/fleet/
hybrid_optimizer.py; reference: Paddle's hybrid_parallel_optimizer.py:253,
the tensor-parallel-aware gradient clip).

Data-parallel gradients are reduced by TrainStep (or DataParallel's
hooks) before the clip, so what this wrapper adds is the clip's global
norm over the other axes: the square-sum of the tensor-parallel
parameters' gradients (partial on each mp rank) all-reduced over the mp
group, the replicated ones counted once, and the whole all-reduced over
the pipeline and sharding groups (disjoint parameters). Over data
parallelism alone those groups are one rank each and nothing more is
reduced; the reductions are written as the reference writes them so that
later slices only turn them on.
"""
from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm, grad_square_sum
from ..collective import ReduceOp, all_reduce


def _is_mp_sharded(p) -> bool:
    spec = getattr(p, "_pspec", None)
    return spec is not None and any(
        a == "mp" or (isinstance(a, (tuple, list)) and "mp" in a)
        for a in spec)


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """Global-norm clip whose square-sum is all-reduced over the mp, pp
    and sharding groups, so every rank scales by the same global norm."""

    def __init__(self, clip_norm, hcg):
        super().__init__(clip_norm)
        self._hcg = hcg

    def _over_pp_sharding(self, sq):
        for group in (self._hcg.get_pipe_parallel_group(),
                      self._hcg.get_sharding_parallel_group()):
            sq = all_reduce(sq, ReduceOp.SUM, group)
        return sq

    def global_square_sum(self, grads, params=None):
        """The reference's `functional_clip` square-sum: over the mp group
        only the tensor-parallel parameters' part is partial and reduced;
        replicated parameters (layernorms, row-parallel biases) carry the
        same gradient on every mp rank and count once."""
        mp = self._hcg.get_model_parallel_group()
        split = mp.nranks > 1 and params is not None
        dist_g = [g for i, g in enumerate(grads)
                  if not split or _is_mp_sharded(params[i])]
        rep_g = [g for i, g in enumerate(grads)
                 if split and not _is_mp_sharded(params[i])]
        dev = grads[0].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        sq_dist = grad_square_sum(dist_g) if dist_g else zero
        sq_rep = grad_square_sum(rep_g) if rep_g else zero.clone()
        if mp.nranks > 1:
            sq_dist = all_reduce(sq_dist.clone(), ReduceOp.SUM, mp)
        return self._over_pp_sharding(sq_dist + sq_rep)

    def factor(self, square_sum):
        """The factor from this rank's square-sum of every gradient (the
        fused AdamW's path). It cannot tell tensor-parallel gradients from
        replicated ones, so under an mp group of more than one rank it
        raises: mp layers wait for a later slice (ROADMAP queue 1)."""
        if self._hcg.get_model_parallel_group().nranks > 1:
            raise NotImplementedError(
                "HybridParallelClipGrad.factor: tensor parallelism (mp "
                "degree > 1) waits for fleet/mp_layers.py (ROADMAP queue 1, "
                "item 3)")
        return super().factor(self._over_pp_sharding(square_sum.clone()))

    def __call__(self, params_grads):
        if not params_grads:
            return []
        s = super().factor(self.global_square_sum(
            [g for _, g in params_grads], [p for p, _ in params_grads]))
        return [(p, (g.float() * s).to(g.dtype)) for p, g in params_grads]


class HybridParallelOptimizer:
    """Wraps an optimizer: its global-norm clip becomes a
    HybridParallelClipGrad; everything else passes through."""

    def __init__(self, optimizer, hcg, strategy=None):
        self._inner = optimizer
        self._hcg = hcg
        self._strategy = strategy
        clip = optimizer._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm) and \
                not isinstance(clip, HybridParallelClipGrad):
            optimizer._grad_clip = HybridParallelClipGrad(clip.clip_norm,
                                                          hcg)

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def step(self):
        self._inner.step()

    def clear_grad(self, *a, **k):
        self._inner.clear_grad(*a, **k)
