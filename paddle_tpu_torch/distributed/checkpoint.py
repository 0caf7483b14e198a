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

The reference's Orbax half (save_sharded, wait_all, save_model_sharded,
load_model_sharded: device-sharded arrays under one writer) is not ported.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["load_sharded", "split_bounds", "write_rank_shard",
           "write_shard_index", "validate_rank_sharded", "is_rank_sharded"]

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


def _host_rows(leaf, a: Optional[int], b: Optional[int]):
    """(C-contiguous host array of rows [a, b) of `leaf`, or the whole
    0-d leaf, dtype name)."""
    from ..resilience.checkpoint_manager import _np_leaf, _tensor_leaf

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

    if torch.is_tensor(leaf):
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
            f"{path} is not a rank-sharded checkpoint; the Orbax layout is "
            f"not ported (ROADMAP queue 1)")
    return _load_rank_sharded(path, template,
                              target_world_size=target_world_size,
                              target_rank=target_rank)
