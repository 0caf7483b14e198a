"""HybridParallelOptimizer (counterpart of paddle_tpu/distributed/fleet/
hybrid_optimizer.py; reference: Paddle's hybrid_parallel_optimizer.py:253,
the tensor-parallel-aware gradient clip).

Data-parallel gradients are reduced by TrainStep (or DataParallel's
hooks) before the clip, so what this wrapper adds is the clip's global
norm over the other axes: the square-sum of the tensor-parallel
parameters' gradients (each mp rank's blocks) all-reduced over the mp
group, the replicated ones counted once; under pipeline parallelism
(fleet/pipeline_parallel.py) the square-sum of this rank's stage
parameters all-reduced over the pp group, the tied ends and the loss
parameters, which every stage holds alike, counted once (the marks
PipelineParallel puts on its parameters, nn/clip.py pp_mark). Summing
every gradient over the pp group would count the tied ends once a stage.
The sharding group is not reduced over here, though the reference does
it: under ZeRO (distributed/sharding.py) the optimizer's square-sum is
already its shard's summed once over the sharding group, and at stage
"os" a rank's whole gradient summed over the group would count every
element W times; without ZeRO the sharding ranks hold the same
gradients.
"""
from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm, grad_square_sum, pp_mark
from ..collective import ReduceOp, all_reduce


def _is_mp_sharded(p) -> bool:
    spec = getattr(p, "_pspec", None)
    return spec is not None and any(
        a == "mp" or (isinstance(a, (tuple, list)) and "mp" in a)
        for a in spec)


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """Global-norm clip whose square-sum is all-reduced over the mp group
    (the mp blocks') and the pp group (the stages'), the sharding group's
    sum being the ZeRO optimizer's, once, so every rank scales by the
    same global norm."""

    def __init__(self, clip_norm, hcg):
        super().__init__(clip_norm)
        self._hcg = hcg

    def global_square_sum(self, grads, params=None):
        """The reference's `functional_clip` square-sum: over the mp group
        only the tensor-parallel parameters' part is partial and reduced;
        replicated parameters (layernorms, row-parallel biases) carry the
        same gradient on every mp rank and count once. Under pipeline
        parallelism, alone or beside dp and mp, this rank's stage
        parameters' part is reduced over the pp group after its mp part
        over the mp group, the tied ends count once, and the dp replicas,
        which hold the averaged gradients, add nothing (nn/clip.py
        grad_square_sum)."""
        if params is not None and any(pp_mark(p) for p in params):
            return grad_square_sum(grads, params)
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
        return sq_dist + sq_rep

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
