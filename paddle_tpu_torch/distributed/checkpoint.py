"""The rank-sharded checkpoint (counterpart of the rank-sharded half of
paddle_tpu/distributed/checkpoint.py): N writer ranks, each durably
committing its own slice, readable later at a different N.

Layout under `path`, the reference's byte for byte (so either package
reads what the other wrote, at any world size):

    shards.json               index: world size, state skeleton, global
                              leaf shapes/dtypes, commit nonce
    shard_00000/
        shard.json            per-array {i, file, rows, crc32} + nonce
        arr_0.bin ...         this rank's rows of each leaf, raw bytes

Leaves are split along axis 0 with numpy.array_split bounds (the first
n % world shards get one extra row), the rule the elastic trainer slices
batches by, so shard r is exactly dp-rank r's state. Scalars (ndim 0)
live in shard 0 only. Every shard embeds the index's nonce: a half-written
retry mixing shards from two save attempts never validates.

Leaves are torch tensors (on any device), numpy arrays or numpy scalars,
as for resilience.CheckpointManager; bfloat16 is written as its raw
2-byte words under the dtype name "bfloat16", as the reference writes a
jax bfloat16 array. A rank copies only its own rows of a device leaf to
the host. The array files are written, checksummed and validated by a
small pool of threads (crc32 and the file calls release the GIL). Loads
return host torch tensors, or tensors on the device of the matching
`template` leaf.

The reference's other half (save_sharded, wait_all, save_model_sharded,
load_model_sharded, CheckpointSaveError) writes device-sharded arrays
with Orbax. The port cannot import Orbax, so `save_sharded` writes this
layout: every rank of the world (torch.distributed's default group; one
process is world 1) writes its rows of every leaf, and a leaf that the
ranks hold in parts (ZeRO's sharded entries, distributed/sharding.py:
anything with `rows(a, b)`) is gathered leaf by leaf first, a collective
in leaf order. The reference's `load_sharded` reads this layout back
(it dispatches on `is_rank_sharded`), at the saved world size or
re-sliced. The write keeps the reference's crash-consistent overwrite:
the shards land in `path + ".saving"`; rank 0 waits until every rank's
shard is there, writes the index and swaps the directory in (the old
checkpoint is moved aside and deleted only after); the other ranks wait
for the commit, so when `save_sharded` (or, for `async_save`, `wait_all`)
returns on any rank the checkpoint is whole. A rank that fails leaves a
marker in the `.saving` directory that stops the others' waits. With
`async_save` the snapshot (each rank's rows, on the host) is taken before
the call returns and the files are written by a thread; `wait_all` joins
every pending save and raises one CheckpointSaveError with every cause.
A directory the reference wrote with Orbax raises in `load_sharded`,
naming it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_sharded", "load_sharded", "save_model_sharded",
           "load_model_sharded", "wait_all", "CheckpointSaveError",
           "split_bounds", "write_rank_shard", "write_shard_index",
           "validate_rank_sharded", "is_rank_sharded"]

COMMIT_TIMEOUT_S = 600.0    # a rank's wait for the others' shards
_POLL_S = 0.02

_SHARD_INDEX = "shards.json"
_SHARD_JSON = "shard.json"


def split_bounds(n: int, world_size: int) -> List[Tuple[int, int]]:
    """[start, stop) row bounds per rank, numpy.array_split semantics."""
    n, world_size = int(n), int(world_size)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    base, extra = divmod(n, world_size)
    bounds, start = [], 0
    for r in range(world_size):
        stop = start + base + (1 if r < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def _shard_dir(path: str, rank: int) -> str:
    return os.path.join(path, f"shard_{int(rank):05d}")


def is_rank_sharded(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _SHARD_INDEX))


def _fsync_write(fpath: str, data) -> None:
    with open(fpath, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class _Rows:
    """A leaf snapshotted for one rank's shard: the whole leaf's `shape`
    and `dtype` name, and this rank's rows (the whole of a 0-d leaf) as a
    host array, `data`."""

    __slots__ = ("shape", "dtype", "data")

    def __init__(self, shape, dtype, data):
        self.shape, self.dtype, self.data = tuple(shape), dtype, data


def _host_rows(leaf, a: Optional[int], b: Optional[int]):
    """(C-contiguous host array of rows [a, b) of `leaf`, or the whole
    0-d leaf, dtype name)."""
    from ..resilience.checkpoint_manager import _np_leaf, _tensor_leaf

    if isinstance(leaf, _Rows):
        return leaf.data, leaf.dtype
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if a is not None:
            t = t[a:b]
        out = _tensor_leaf(t.contiguous().cpu())
    else:
        arr = np.asarray(leaf)
        out = _np_leaf(arr if a is None else arr[a:b], copy=False)
    return out.array, out.dtype


def _spec(leaf) -> Dict[str, Any]:
    from ..resilience.checkpoint_manager import _TORCH_TO_NP

    if isinstance(leaf, _Rows):
        name = leaf.dtype
    elif isinstance(getattr(leaf, "dtype", None), torch.dtype):
        name = _TORCH_TO_NP[leaf.dtype][1]
    else:
        name = np.asarray(leaf).dtype.name
    shape = list(leaf.shape)
    return {"shape": shape, "dtype": name, "scalar": len(shape) == 0}


def write_rank_shard(path: str, rank: int, world_size: int, state: Any,
                     nonce: str) -> Dict[str, Any]:
    """Write rank `rank`'s slice of `state` under `path`. Returns the
    index payload (skeleton + global leaf specs): every rank computes the
    identical one from its full-state view, and rank 0 passes it to
    write_shard_index. Crash-safe: the shard lands in a `.tmp` directory
    renamed into place, so a torn shard is never picked up."""
    from ..resilience import chaos
    from ..resilience.checkpoint_manager import _encode, _parallel

    rank, world_size = int(rank), int(world_size)
    leaves: List[Any] = []
    skeleton = _encode(state, leaves)
    sdir = _shard_dir(path, rank)
    tmp = sdir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    specs = [_spec(leaf) for leaf in leaves]
    mine = []                       # (i, rows) of the leaves this rank holds
    for i, (leaf, spec) in enumerate(zip(leaves, specs)):
        if spec["scalar"]:
            if rank == 0:           # scalars: shard 0 only
                mine.append((i, None))
        else:
            a, b = split_bounds(spec["shape"][0], world_size)[rank]
            mine.append((i, [int(a), int(b)]))

    def write(item):
        i, rows = item
        arr, _ = _host_rows(leaves[i], *(rows or (None, None)))
        buf = memoryview(arr.reshape(-1).view(np.uint8))
        fname = f"arr_{i}.bin"
        _fsync_write(os.path.join(tmp, fname), buf)
        return {"i": i, "file": fname, "rows": rows,
                "crc32": zlib.crc32(buf) & 0xFFFFFFFF}

    arrays = _parallel(write, mine)
    shard_meta = {"nonce": str(nonce), "rank": rank,
                  "world_size": world_size, "arrays": arrays}
    _fsync_write(os.path.join(tmp, _SHARD_JSON),
                 json.dumps(shard_meta).encode())
    chaos.crash_point("ckpt.shard")
    if os.path.exists(sdir):
        shutil.rmtree(sdir)
    os.rename(tmp, sdir)
    return {"version": 1, "world_size": world_size, "nonce": str(nonce),
            "skeleton": skeleton, "leaves": specs}


def write_shard_index(path: str, index: Dict[str, Any]) -> None:
    """Commit the index (rank 0, after its own shard): tmp + os.replace so
    `is_rank_sharded` only ever sees a complete index."""
    ipath = os.path.join(path, _SHARD_INDEX)
    _fsync_write(ipath + ".tmp", json.dumps(index).encode())
    os.replace(ipath + ".tmp", ipath)


def validate_rank_sharded(path: str) -> Optional[str]:
    """None if every shard of the checkpoint at `path` is present, nonce-
    consistent and checksum-valid; else a human-readable reason."""
    from ..resilience.checkpoint_manager import _crc32_file, _parallel

    try:
        with open(os.path.join(path, _SHARD_INDEX)) as f:
            index = json.load(f)
    except FileNotFoundError:
        return "missing shard index"
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable shard index: {e}"
    world = int(index.get("world_size", 0))
    if world < 1:
        return f"bad world_size {index.get('world_size')!r}"
    for r in range(world):
        sdir = _shard_dir(path, r)
        try:
            with open(os.path.join(sdir, _SHARD_JSON)) as f:
                smeta = json.load(f)
        except FileNotFoundError:
            return f"missing shard {r}/{world}"
        except (OSError, json.JSONDecodeError) as e:
            return f"unreadable shard {r} metadata: {e}"
        if smeta.get("nonce") != index.get("nonce"):
            return (f"shard {r} nonce {smeta.get('nonce')!r} does not "
                    f"match index nonce {index.get('nonce')!r} "
                    f"(mixed save attempts)")
        entries = list(smeta.get("arrays", ()))

        def crc(entry):
            try:
                return _crc32_file(os.path.join(sdir, entry["file"]))
            except OSError:
                return None

        for entry, got in zip(entries, _parallel(crc, entries)):
            if got is None:
                return f"missing array file shard {r}/{entry['file']}"
            if got != entry["crc32"]:
                return f"checksum mismatch in shard {r}/{entry['file']}"
    return None


def _shard_dtype(name: str) -> np.dtype:
    """The numpy dtype of a leaf's stored words (bfloat16: its uint16
    words)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _read_shard_leaf(path: str, rank: int, leaf_i: int,
                     dtype: np.dtype, tail_shape) -> np.ndarray:
    fpath = os.path.join(_shard_dir(path, rank), f"arr_{leaf_i}.bin")
    buf = bytearray(os.path.getsize(fpath))
    with open(fpath, "rb") as f:
        f.readinto(buf)
    return np.frombuffer(buf, dtype=dtype).reshape((-1, *tail_shape))


def _as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _load_rank_sharded(path: str, template, *,
                       target_world_size: Optional[int],
                       target_rank: int):
    from ..resilience.checkpoint_manager import (_decode, _parallel,
                                                 _place_like)

    with open(os.path.join(path, _SHARD_INDEX)) as f:
        index = json.load(f)
    src_world = int(index["world_size"])
    T = int(target_world_size if target_world_size is not None
            else src_world)
    t = int(target_rank)
    if not (0 <= t < T):
        raise ValueError(f"target_rank {t} out of range for "
                         f"target_world_size {T}")

    def load(item):
        i, spec = item
        dtype = _shard_dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        if spec.get("scalar"):
            arr = _read_shard_leaf(path, 0, i, dtype, ()).reshape(())
            return _as_tensor(arr, spec["dtype"])
        n, tail = shape[0], shape[1:]
        a, b = split_bounds(n, T)[t]
        pieces = []
        for r, (sa, sb) in enumerate(split_bounds(n, src_world)):
            lo, hi = max(a, sa), min(b, sb)
            if lo < hi:
                src = _read_shard_leaf(path, r, i, dtype, tail)
                pieces.append(src[lo - sa:hi - sa])
        if len(pieces) == 1:
            arr = pieces[0]
        elif pieces:
            arr = np.concatenate(pieces)
        else:
            arr = np.empty((0, *tail), dtype=dtype)
        return _as_tensor(arr.reshape((b - a, *tail)), spec["dtype"])

    leaves = _parallel(load, list(enumerate(index["leaves"])))
    state = _decode(index["skeleton"], leaves)
    if template is not None:
        state = _place_like(state, template)
    return state


def _snapshot(leaf, rank: int, world: int) -> _Rows:
    """Rank `rank`'s rows of `leaf` at `world` ranks as a host copy (the
    whole of a 0-d leaf; a leaf with `rows` gathers them: a collective)."""
    spec = _spec(leaf)
    lazy = hasattr(leaf, "rows")
    if spec["scalar"]:
        arr, name = _host_rows(leaf.full() if lazy else leaf, None, None)
    else:
        a, b = split_bounds(spec["shape"][0], world)[rank]
        if lazy:
            arr, name = _host_rows(leaf.rows(a, b), None, None)
        else:
            arr, name = _host_rows(leaf, a, b)
    return _Rows(spec["shape"], spec["dtype"], np.array(arr, copy=True))


class CheckpointSaveError(RuntimeError):
    """One or more (async) checkpoint saves failed; carries every cause."""

    def __init__(self, errors):
        super().__init__(
            "checkpoint save failed: "
            + "; ".join(f"{type(e).__name__}: {e}" for e in errors))
        self.errors = list(errors)


def _commit_swap(tmp: str, final: str) -> None:
    """Promote `tmp` to `final`; the old checkpoint is moved aside first
    and deleted only after the new one is in place."""
    old = None
    if os.path.exists(final):
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old)


def _failure(tmp: str) -> Optional[str]:
    """The first failure marker a rank left in `tmp`, or None."""
    try:
        names = sorted(n for n in os.listdir(tmp) if n.startswith("failed_"))
    except OSError:
        return None
    for n in names:
        try:
            with open(os.path.join(tmp, n)) as f:
                return f"{n[len('failed_'):]}: {f.read()}"
        except OSError:
            return n
    return None


def _index_nonce(path: str) -> Optional[str]:
    try:
        with open(os.path.join(path, _SHARD_INDEX)) as f:
            return json.load(f).get("nonce")
    except (OSError, ValueError):
        return None


def _shard_nonce(path: str, rank: int) -> Optional[str]:
    try:
        with open(os.path.join(_shard_dir(path, rank), _SHARD_JSON)) as f:
            return json.load(f).get("nonce")
    except (OSError, ValueError):
        return None


class _PendingSave:
    """One rank's part of a save: its shard written into `tmp`, then rank
    0's commit (every shard present, the index, the swap) or another
    rank's wait for it. `run` on the caller's thread, or `start` and
    later `finish` (which re-raises the thread's error); `close` is the
    reference's, a no-op here."""

    def __init__(self, state, tmp, final, rank, world, nonce):
        self.state, self.tmp, self.final = state, tmp, final
        self.rank, self.world, self.nonce = rank, world, nonce
        self.thread = None
        self.error = None

    def run(self):
        try:
            os.makedirs(self.tmp, exist_ok=True)
            index = write_rank_shard(self.tmp, self.rank, self.world,
                                     self.state, self.nonce)
            if self.rank == 0:
                self._wait(lambda: all(
                    _shard_nonce(self.tmp, r) == self.nonce
                    for r in range(self.world)), "every rank's shard")
                write_shard_index(self.tmp, index)
                _commit_swap(self.tmp, self.final)
            else:
                self._wait(lambda: _index_nonce(self.final) == self.nonce,
                           "rank 0's commit")
        except BaseException as e:
            try:
                with open(os.path.join(self.tmp,
                                       f"failed_{self.rank}"), "w") as f:
                    f.write(f"{type(e).__name__}: {e}")
            except OSError:
                pass
            raise

    def _wait(self, done, what):
        deadline = time.monotonic() + COMMIT_TIMEOUT_S
        while not done():
            failed = _failure(self.tmp)
            if failed is not None:
                raise RuntimeError(f"save of {self.final}: rank {failed}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"save of {self.final}: no {what} after "
                                   f"{COMMIT_TIMEOUT_S} s")
            time.sleep(_POLL_S)

    def start(self):
        def body():
            try:
                self.run()
            except BaseException as e:  # surfaced by finish()
                self.error = e

        self.thread = threading.Thread(target=body, name="sharded-save",
                                       daemon=True)
        self.thread.start()

    def finish(self):
        if self.thread is not None:
            self.thread.join()
        if self.error is not None:
            raise self.error

    def close(self):
        pass


_pending: List[Any] = []


def _agree_nonce(rank: int, world: int) -> str:
    """Rank 0's fresh nonce, on every rank of the world."""
    nonce = [uuid.uuid4().hex]
    if world > 1:
        import torch.distributed as tdist

        tdist.broadcast_object_list(nonce, src=0)
    return nonce[0]


def save_sharded(state: Any, path: str, async_save: bool = False,
                 overwrite: bool = True):
    """Write a (nested) state of tensors and arrays rank-sharded under
    `path`: every rank of the world calls it with the same structure and
    writes its rows (see the module note). With async_save=True it
    returns once this rank's rows are on the host; call wait_all() (or
    save again) to join the write and the commit."""
    from .collective import _global_rank_world

    rank, world = _global_rank_world()
    _save(state, path, async_save, overwrite, rank, world)


def _save(state, path, async_save, overwrite, rank, world):
    """save_sharded as rank `rank` of `world` writers."""
    from ..resilience.checkpoint_manager import _decode, _encode

    path = os.path.abspath(path)
    # an in-flight save's swap must not race this one's
    wait_all()
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    leaves: List[Any] = []
    skeleton = _encode(state, leaves)
    snap = _decode(skeleton, [_snapshot(x, rank, world) for x in leaves])
    nonce = _agree_nonce(rank, world)
    tmp = path + ".saving"
    if rank == 0 and os.path.exists(tmp):   # debris of a crashed save
        shutil.rmtree(tmp)
    if world > 1:
        from .collective import barrier

        barrier()               # the debris is gone before any rank writes
    pending = _PendingSave(snap, tmp, path, rank, world, nonce)
    if async_save:
        pending.start()
        _pending.append(pending)
    else:
        pending.run()


def wait_all():
    """Join every pending async save: each is finished and closed, then
    the failures re-raise as one CheckpointSaveError."""
    errors = []
    while _pending:
        c = _pending.pop()
        try:
            c.finish()
        except Exception as e:  # noqa: BLE001 - aggregated below
            errors.append(e)
        finally:
            try:
                c.close()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
    if errors:
        raise CheckpointSaveError(errors)


def save_model_sharded(model, path: str, optimizer=None, async_save=False):
    """Save the model's (and the optimizer's) state rank-sharded under
    `path` as {"model": ..., "optimizer": ...} (the reference's keys;
    its save_group_sharded_model). A model that ZeRO stage 3 shards
    (distributed/sharding.py) gives its parameters in parts, as the
    optimizer its sharded state: each is gathered leaf by leaf."""
    zero = getattr(model, "_zero", None)
    state = {"model": zero.model_state(model) if zero is not None
             else dict(model.state_dict())}
    if optimizer is not None:
        state["optimizer"] = optimizer._state_dict(lazy=True)
    save_sharded(state, path, async_save=async_save)


@torch.no_grad()
def load_model_sharded(model, path: str, optimizer=None):
    """Restore `save_model_sharded`'s checkpoint (or the reference's
    rank-sharded write of the same keys) into the model's current
    placement: the whole state is read on the host (target world 1),
    and under ZeRO each rank keeps its part. Returns the model."""
    restored = load_sharded(path, target_world_size=1)
    zero = getattr(model, "_zero", None)
    sd = model.state_dict()
    params = dict(model.named_parameters())
    missing = sorted(set(sd) - set(restored["model"]))
    if missing:
        raise KeyError(f"{path} lacks the model's {missing}")
    for k, v in restored["model"].items():
        if k not in sd:
            raise KeyError(f"{path} holds {k!r}, which the model lacks")
        p = params.get(k)
        if zero is not None and p is not None and id(p) in zero.where \
                and zero.level == "p_g_os":
            group = zero.where[id(p)][0].group
            zero.assign(group.p, p, v)
        else:
            sd[k].copy_(v.to(sd[k].device))
    if optimizer is not None:
        optimizer.set_state_dict(restored["optimizer"])
    return model


def load_sharded(path: str, template: Optional[Any] = None, *,
                 target_world_size: Optional[int] = None,
                 target_rank: int = 0):
    """Restore a rank-sharded checkpoint (the write_rank_shard layout),
    re-sliced on load: returns target rank `target_rank`'s slice of every
    leaf at world size `target_world_size` (default: the saved world
    size), reading only the source shards that overlap it, bitwise equal
    to gathering the full arrays and re-slicing. `target_world_size=1`
    gathers the full state. `template` places each leaf on its template
    leaf's device."""
    path = os.path.abspath(path)
    if not is_rank_sharded(path):
        raise NotImplementedError(
            f"{path} is not a rank-sharded checkpoint: a directory the "
            "reference wrote with Orbax cannot be read without Orbax, "
            "which the port does not use")
    return _load_rank_sharded(path, template,
                              target_world_size=target_world_size,
                              target_rank=target_rank)
