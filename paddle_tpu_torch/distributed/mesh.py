"""Process mesh and hybrid topology (counterpart of paddle_tpu/distributed/
mesh.py; reference: Paddle's CommunicateTopology and
HybridCommunicateGroup, fleet/base/topology.py:58, :144).

The reference's mesh is one jax Mesh of devices with named axes. Here the
ranks (processes) are the grid: `build_mesh` lays ranks 0..N-1 out in
AXIS_ORDER (row-major, dp outermost) and makes, for every axis, the
process group of each line of ranks along it, on every rank and in one
order, as torch.distributed.new_group requires. Each rank keeps the
groups it lies on (`Mesh.group(axis)`), and with both dp and sep above
one rank, its group over the two (`Mesh.joint_group(("dp", "sep"))`,
data x context parallelism's gradient reduction); an axis of size 1 is
a group of one rank, whose collectives are the identity. Ranks past the
mesh's size lie on no group.

Parameter sharding (tensor parallelism). The reference annotates a
whole-shaped parameter with a PartitionSpec and places it with a
NamedSharding, and GSPMD partitions the program. Here each mp rank holds
its own block: `annotate_param` records the spec as `p._pspec` and, under
a mesh whose mp axis has more than one rank, cuts the parameter to this
rank's contiguous block along the annotated dimension (`shard_param`:
`p.data` becomes the block; `p._mp_shard` holds the group and the
dimension, `p._full_shape` the whole shape). `shard_block` takes a
parameter's block of a whole-shaped tensor or array: a model fills a
cut parameter with its block of the whole draw from its generator, so a
model built at mp = n from a seed holds exactly the blocks of the model
built at mp = 1 from that seed; `models.convert.load_jax_state_dict`
takes the block of a reference array the same way. Only the mp axis
cuts. A spec over the `sharding` axis (ZeRO stage 3's placement,
sharding_utils.shard_model_parameters) is recorded and cuts nothing
here: the port's ZeRO partition is a contiguous range of the optimizer's
flat buffer, which distributed/sharding.py makes and gathers at use.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

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

    def joint_group(self, axes: Sequence[str]):
        """This rank's Group over several axes: the one axis's own group
        when the others are one rank each; otherwise a group that
        build_mesh made (dp and sep)."""
        big = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        if len(big) <= 1:
            return self.group(big[0] if big else axes[0])
        if big not in self._groups:
            raise ValueError(f"no group over the axes {big} of the mesh "
                             f"{self.shape}")
        return self._groups[big]

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
    if dp > 1 and sep > 1:
        # the gradient reduction of data x sequence parallelism: every
        # line of ranks over both axes (jit.TrainStep)
        lines = np.moveaxis(grid, (0, 3), (-2, -1)).reshape(-1, dp * sep)
        joint = Group(-1, dp * sep, -1, [], axis_name="dp,sep")
        for line in lines:
            g = _make_group(line.tolist(), axis_name="dp,sep")
            if me in line:
                joint = g
        groups[("dp", "sep")] = joint
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


class PartitionSpec(tuple):
    """The reference's jax.sharding.PartitionSpec: an entry a dimension,
    None (whole), an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _spec_axes(entry):
    return entry if isinstance(entry, (tuple, list)) else (entry,)


def annotate_param(p, spec, name=None):
    """Record `spec` as `p._pspec` and, under the current mesh, cut `p` to
    this rank's block along every dimension the spec shards over an mp
    axis of more than one rank (see the module note). An axis the mesh
    does not have raises, as in the reference; so does a dimension the
    axis size does not divide (the reference warns and leaves GSPMD to
    pad: ROADMAP, faults of the reference). `name` names the parameter in
    that error."""
    spec = PartitionSpec(*spec)
    p._pspec = spec
    if _current_mesh is not None:
        place_param(p, spec, _current_mesh, name)
    return p


# the ROADMAP queue 1 item that a placement over each axis waits for
_GSPMD_ITEM = "the rest of distributed/, GSPMD placements"
_PLACEMENT_ITEM = {"ep": "MoE and expert parallelism"}


def place_param(p, spec, mesh, name=None):
    """Cut `p` by `spec` over `mesh` (annotate_param's placement, and
    sharding_utils.shard_model_parameters'): an axis the mesh lacks
    raises ValueError; an mp axis of more than one rank cuts; a sharding
    axis is recorded only (see the module note); any other axis of more
    than one rank raises NotImplementedError, naming it."""
    for entry in spec:
        for a in _spec_axes(entry):
            if a is not None and a not in mesh.axis_names:
                raise ValueError(
                    ("" if name is None else f"{name}: ")
                    + f"sharding spec {spec} names axis {a!r} which is not "
                    f"in mesh axes {mesh.axis_names}")
    for dim, entry in enumerate(spec):
        for a in _spec_axes(entry):
            if a is None or mesh.shape[a] == 1 or a == "sharding":
                continue
            if a != "mp":
                raise NotImplementedError(
                    ("" if name is None else f"{name}: ")
                    + f"placing a parameter over the {a!r} axis "
                    f"({mesh.shape[a]} ranks) is not ported (ROADMAP "
                    f"queue 1: {_PLACEMENT_ITEM.get(a, _GSPMD_ITEM)})")
            shard_param(p, dim, mesh.group("mp"), name)
    return p


def shard_param(p, dim, group, name=None):
    """Cut the whole parameter `p` in place to `group.rank`'s contiguous
    block of `group.nranks` along `dim` (`p.data` becomes a copy of the
    block). A group of one rank, or one this rank is outside, leaves it
    whole; a parameter already cut over `group` along `dim` is left as it
    is."""
    if group.nranks <= 1 or group.rank < 0:
        return p
    cut = getattr(p, "_mp_shard", None)
    if cut is not None:
        if cut == (group, dim):
            return p
        raise ValueError(f"parameter {name or tuple(p.shape)} is already "
                         f"cut along dim {cut[1]} over {cut[0]}")
    size, n = p.shape[dim], group.nranks
    if size % n:
        raise ValueError(
            f"parameter {name or 'of shape ' + str(tuple(p.shape))}: dim "
            f"{dim} ({size}) does not divide into {n} ranks of 'mp'")
    m = size // n
    full = tuple(p.shape)
    with torch.no_grad():
        p.data = p.data.narrow(dim, group.rank * m, m).clone()
    p._mp_shard = (group, dim)
    p._full_shape = full
    return p


def mp_group_of(p):
    """The group `p` is cut over, or None for a whole parameter."""
    cut = getattr(p, "_mp_shard", None)
    return None if cut is None else cut[0]


def full_shape(p):
    """The whole shape of parameter `p` (its own shape when whole)."""
    return getattr(p, "_full_shape", None) or tuple(p.shape)


def shard_block(whole, p):
    """`p`'s block of `whole`, a whole-shaped tensor or numpy array (a view
    of it; `whole` itself when `p` is whole)."""
    cut = getattr(p, "_mp_shard", None)
    if cut is None:
        return whole
    group, dim = cut
    m = whole.shape[dim] // group.nranks
    idx = [slice(None)] * len(whole.shape)
    idx[dim] = slice(group.rank * m, (group.rank + 1) * m)
    return whole[tuple(idx)]


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
