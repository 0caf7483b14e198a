"""Process mesh and hybrid topology (counterpart of paddle_tpu/distributed/
mesh.py, as far as data parallelism needs it; reference: Paddle's
CommunicateTopology and HybridCommunicateGroup, fleet/base/topology.py:58,
:144).

The reference's mesh is one jax Mesh of devices with named axes. Here the
ranks (processes) are the grid: `build_mesh` lays ranks 0..N-1 out in
AXIS_ORDER (row-major, dp outermost) and makes, for every axis, the
process group of each line of ranks along it, on every rank and in one
order, as torch.distributed.new_group requires. Each rank keeps the
groups it lies on (`Mesh.group(axis)`); an axis of size 1 is a group of
one rank, whose collectives are the identity. Ranks past the mesh's size
lie on no group. `annotate_param` (sharding a parameter over an axis)
waits for a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

AXIS_ORDER = ("dp", "pp", "sharding", "sep", "ep", "mp")

_current_mesh = None


class Mesh:
    """A grid of global ranks with named axes, and this rank's group along
    each axis. `shape` maps axis names to sizes in AXIS_ORDER (the jax
    Mesh's `shape`); `ranks` is the grid itself."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 groups: Dict[str, object]):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(self.axis_names,
                                                ranks.shape)}
        self._groups = groups

    def group(self, axis: str):
        """This rank's Group along `axis` (rank -1 when it lies outside)."""
        if axis not in self._groups:
            raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                             f"{self.shape}")
        return self._groups[axis]

    def coordinate(self, rank: int) -> Optional[Dict[str, int]]:
        """The grid position of a global rank, or None outside the mesh."""
        hit = np.argwhere(self.ranks == rank)
        if not len(hit):
            return None
        return dict(zip(self.axis_names, map(int, hit[0])))

    def __repr__(self):
        return f"Mesh({self.shape})"


def build_mesh(dp: int = 1, mp: int = 1, pp: int = 1, sharding: int = 1,
               sep: int = 1, ep: int = 1, devices=None) -> Mesh:
    """Lay ranks out over the axes; collective over every rank of the
    world (each must call it with the same sizes). `devices` is accepted
    for the reference's signature: a rank owns its device."""
    from .collective import Group, _global_rank_world, _make_group

    sizes = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep,
             "ep": ep, "mp": mp}
    total = int(np.prod(list(sizes.values())))
    me, world = _global_rank_world()
    if total > world:
        raise ValueError(f"mesh needs {total} ranks, have {world}")
    grid = np.arange(total).reshape([sizes[a] for a in AXIS_ORDER])
    groups = {}
    for k, axis in enumerate(AXIS_ORDER):
        # every line of ranks along `axis`, in grid order
        lines = np.moveaxis(grid, k, -1).reshape(-1, sizes[axis])
        for line in lines:
            g = _make_group(line.tolist(), axis_name=axis)
            if me in line:
                groups[axis] = g
        if axis not in groups:      # this rank lies past the mesh
            groups[axis] = Group(-1, sizes[axis], -1, [], axis_name=axis)
    return Mesh(grid, AXIS_ORDER, groups)


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def auto_mesh() -> Mesh:
    """The data-parallel mesh over every rank (made once)."""
    global _current_mesh
    if _current_mesh is None:
        from .collective import _global_rank_world

        _current_mesh = build_mesh(dp=_global_rank_world()[1])
    return _current_mesh


def annotate_param(p, spec):
    """Sharding a parameter over mesh axes is not ported yet."""
    raise NotImplementedError(
        "annotate_param: parameter sharding over a mesh axis waits for "
        "sharding.py (ROADMAP queue 1, item 3: the rest of distributed/)")


class ProcessMesh:
    """Semi-auto-parallel mesh (reference: Paddle's auto_parallel
    ProcessMesh): process ids on a grid with named dimensions. Here the
    processes are the ranks."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None,
                 shape=None, process_ids=None):
        from .collective import _global_rank_world

        arr = np.asarray(mesh)
        self._shape = list(arr.shape)
        self._process_ids = arr.flatten().tolist()
        self._dim_names = list(dim_names) if dim_names else \
            [f"d{i}" for i in range(arr.ndim)]
        world = _global_rank_world()[1]
        if max(self._process_ids) >= world:
            raise ValueError(
                f"ProcessMesh names process {max(self._process_ids)} but "
                f"the world has {world} ranks")

    @property
    def shape(self):
        return self._shape

    @property
    def process_ids(self):
        return self._process_ids

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def ndim(self):
        return len(self._shape)

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dims={self._dim_names})"


class CommunicateTopology:
    """Reference: fleet/base/topology.py:58."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "sep", "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = {}
        self._world = int(np.prod(self._dims))

    def world_size(self):
        return self._world

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def get_hybrid_group_names(self):
        return self._parallel_names


class HybridCommunicateGroup:
    """Reference: fleet/base/topology.py:144. Builds the mesh of the
    topology's degrees over the ranks (set as the current mesh) and hands
    out this rank's group and position along each axis; the reference,
    single-controller, reports position 0 on every axis."""

    _AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                 "sep": "sep", "model": "mp"}

    def __init__(self, topology: CommunicateTopology):
        from .collective import _global_rank_world

        self._topo = topology
        names = topology.get_hybrid_group_names()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._mp_degree = topology.get_dim("model")
        self.global_rank = _global_rank_world()[0]
        self.mesh = build_mesh(dp=self._dp_degree, mp=self._mp_degree,
                               pp=self._pp_degree,
                               sharding=self._sharding_degree,
                               sep=self._sep_degree)
        set_mesh(self.mesh)
        self._coord = self.mesh.coordinate(self.global_rank) or \
            {a: -1 for a in AXIS_ORDER}

    # --- reference API surface ---
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_data_parallel_group(self):
        return self.mesh.group("dp")

    def get_model_parallel_group(self):
        return self.mesh.group("mp")

    def get_pipe_parallel_group(self):
        return self.mesh.group("pp")

    def get_sharding_parallel_group(self):
        return self.mesh.group("sharding")

    def get_sep_parallel_group(self):
        return self.mesh.group("sep")

    def get_data_parallel_rank(self):
        return self._coord["dp"]

    def get_model_parallel_rank(self):
        return self._coord["mp"]

    def get_stage_id(self):
        return self._coord["pp"]

    def get_model_parallel_group_src_rank(self):
        g = self.mesh.group("mp")
        return g.ranks[0] if g.ranks else -1
