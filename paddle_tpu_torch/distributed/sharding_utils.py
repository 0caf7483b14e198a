"""Parameter and batch placement (counterpart of paddle_tpu/distributed/
sharding_utils.py:20-92).

The reference places every parameter on the mesh with a NamedSharding of
its `_pspec` (replicated without one), adds ZeRO's axis to it at stage 3
(`_compose_zero`), and shards a batch's leading dimension over the data
axes; XLA moves the bytes. With a process a rank, placing an mp spec is
cutting: `shard_model_parameters` cuts each annotated parameter to this
rank's block (mesh.shard_param). ZeRO's axis takes no spec here:
distributed/sharding.py cuts each unit's flat span, not a dimension, and
gathers the parameters itself. `shard_batch` returns this rank's rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mesh import place_param


def refuse_zero_beside(mesh, axis: str):
    """Raise when ZeRO over `axis` would sit beside an mp, sep, pp or ep
    axis of more than one rank: the product is not ported."""
    for other in ("mp", "sep", "pp", "ep"):
        if mesh.shape.get(other, 1) > 1:
            item = "MoE and expert parallelism" if other == "ep" \
                else "ZeRO beside mp, sep or pp"
            raise NotImplementedError(
                f"ZeRO (sharding.py) over {axis!r} beside an {other!r} axis "
                f"of {mesh.shape[other]} ranks: the sharding x {other} "
                f"product is not ported (ROADMAP queue 1: {item})")


def shard_model_parameters(model: torch.nn.Module, mesh,
                           zero_axis: Optional[str] = None):
    """Cut every annotated parameter of `model` (a model built before the
    mesh existed: its mp layers recorded their specs and kept their
    weights whole) to this rank's block over the mesh's mp axis;
    parameters without a spec stay whole (replicated). A spec naming an
    axis the mesh lacks, or a dimension the axis does not divide, raises
    naming the parameter (the reference warns and replicates: ROADMAP,
    faults of the reference). `zero_axis` (ZeRO stage 3) cuts nothing
    here: distributed/sharding.py partitions the parameters over it as
    flat spans (its module note), so no spec names it; beside an mp, sep,
    pp or ep axis of more than one rank it raises (refuse_zero_beside)."""
    if zero_axis is not None:
        refuse_zero_beside(mesh, zero_axis)
    for name, p in model.named_parameters():
        spec = getattr(p, "_pspec", None)
        if spec is not None:
            place_param(p, spec, mesh, name)
    return model


def shard_batch(batch, mesh, axes=("dp",)):
    """This rank's rows of `batch` (a tensor, a numpy array, or a tuple,
    list or dict of them): block k of n along each leading dimension,
    where n is the product of the sizes of `axes` in the mesh (those of
    more than one rank) and k this rank's position over them, row-major
    in the order given. A leading dimension that n does not divide
    raises."""
    from .collective import _global_rank_world

    names = [a for a in axes if a in mesh.axis_names and mesh.shape[a] > 1]
    coord = mesh.coordinate(_global_rank_world()[0])
    n, k = 1, 0
    for a in names:
        n *= mesh.shape[a]
        k = k * mesh.shape[a] + (coord[a] if coord else 0)

    def rows(x):
        if isinstance(x, dict):
            return {key: rows(v) for key, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)) \
                or n == 1 or not x.shape:
            return x
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: leading dim {x.shape[0]} of "
                             f"{tuple(x.shape)} does not split into {n} "
                             f"ranks of {names}")
        m = x.shape[0] // n
        return x[k * m:(k + 1) * m]

    return rows(batch)
