"""Crash-consistent checkpoint manager (counterpart of
paddle_tpu/resilience/checkpoint_manager.py, the "npy" backend).

Layout under `root`, the reference's byte for byte:

    step_00000042/            committed checkpoint (atomic rename target)
        manifest.json         per-array entries {file, shape, dtype, crc32},
                              structure skeleton, user meta, format version
        arr_0.bin ...         raw array bytes, one file per state leaf
    step_00000050.tmp/        in-flight write (never read; GC'd on next save)

Commit protocol (the reference's, checkpoint_manager.py:1-32):

    1. write every array file (fsync each)
    2. write manifest.json.tmp, fsync, os.replace -> manifest.json
    3. os.rename(step_N.tmp, step_N)        <- the commit point
    4. only now GC older checkpoints (keep-last-N, never the last valid one)

A crash at any point leaves either a fully committed directory or an
ignored `.tmp`. `restore_latest()` scans newest-first, re-verifies every
checksum and falls back to the previous checkpoint when it finds torn or
bit-rotted state. The chaos points (`ckpt.begin`, `ckpt.array`,
`ckpt.before_manifest`, `ckpt.before_commit`, `ckpt.before_gc`) sit where
the reference's do.

Leaves are torch tensors (on any device), numpy arrays or numpy scalars;
`restore_latest` returns torch tensors on the host, or on the device of
the matching `template` leaf. bfloat16 needs no ml_dtypes: a bf16 leaf is
written as its raw 2-byte words with the dtype name "bfloat16", which is
what the reference writes for a jax bfloat16 array, and read back through
the same words. So the formats are one: the reference validates and
restores the port's checkpoints and the other way round.

`async_save=True` takes the snapshot on the caller's thread before `save`
returns: every device leaf is copied to fresh pinned host memory (one copy
per device storage, covering the bytes its leaves use, so the optimizer's
flat buffers cross in a few large copies and their per-parameter views are
carved out of the host copy, never aliased), queued after the caller's
kernels on its stream and waited for; host leaves are copied too. The
files and the commit are then written by a background thread; `wait()`
(implied by the next `save` and by `restore_latest`) joins it and
re-raises its error. At most one save is in flight, so commits stay
ordered. The array files are written (each fsynced, its crc32 taken),
validated and read by a small pool of threads, file by file: zlib and the
file calls release the GIL, and a checkpoint of a few GB is otherwise
bound by one core's crc32. The manifest, the commit and the messages are
the reference's; only the order in which files reach the disk differs.

Left for later slices: the reference's "orbax" and "sharded" backends and
the store-synchronised multi-rank commit (checkpoint_manager.py:306-404);
`store=` or `world_size > 1` raises.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import chaos
from ..observability.registry import counter as _obs_counter
from ..observability.spans import span as _span

__all__ = ["CheckpointManager", "CheckpointCorrupt", "RestoredCheckpoint"]

_SAVES = _obs_counter(
    "checkpoint_saves_total",
    "Checkpoint saves by outcome: committed = the atomic rename landed, "
    "failed = the write raised before the commit point.",
    labelnames=("outcome",))

MANIFEST = "manifest.json"
_FORMAT_VERSION = 1
_IO_THREADS = 8
_STEP_RE = re.compile(r"^step_(\d{8,})$")

# torch dtype -> (numpy dtype of the stored words, manifest dtype name)
_TORCH_TO_NP = {
    torch.float32: (np.float32, "float32"),
    torch.float64: (np.float64, "float64"),
    torch.float16: (np.float16, "float16"),
    torch.bfloat16: (np.uint16, "bfloat16"),
    torch.int64: (np.int64, "int64"),
    torch.int32: (np.int32, "int32"),
    torch.int16: (np.int16, "int16"),
    torch.int8: (np.int8, "int8"),
    torch.uint8: (np.uint8, "uint8"),
    torch.bool: (np.bool_, "bool"),
}


class CheckpointCorrupt(RuntimeError):
    pass


class _Leaf:
    """One host array ready to write: C-contiguous words and the dtype
    name the manifest records."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        # np.ascontiguousarray would make a 0-d array 1-d
        self.array = array if array.flags.c_contiguous \
            else array.copy(order="C")
        self.dtype = dtype

    def words(self) -> memoryview:
        return memoryview(self.array.reshape(-1).view(np.uint8))


def _np_leaf(arr: np.ndarray, copy: bool) -> _Leaf:
    arr = np.asarray(arr)
    if copy:
        arr = np.array(arr, copy=True)
    return _Leaf(arr, arr.dtype.name)


def _tensor_leaf(host: torch.Tensor) -> _Leaf:
    np_dtype, name = _TORCH_TO_NP[host.dtype]
    words = host.view(torch.int16) if host.dtype == torch.bfloat16 else host
    return _Leaf(words.numpy().view(np_dtype), name)


def _host_copies(tensors: List[torch.Tensor], copy: bool) -> List[_Leaf]:
    """Host leaves of `tensors`. Device tensors that share a storage cross
    in one copy of the byte range they cover; host tensors are copied only
    when `copy` (an async save must not alias the caller's memory)."""
    out: List[Optional[_Leaf]] = [None] * len(tensors)
    spans: Dict[Tuple[str, int], list] = {}
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.device.type == "cpu":
            t = t.contiguous()
            out[i] = _tensor_leaf(t.clone() if copy else t)
        elif not t.is_contiguous():
            out[i] = _tensor_leaf(t.contiguous().cpu())
        else:
            st = t.untyped_storage()
            key = (str(t.device), st.data_ptr())
            off = t.storage_offset() * t.element_size()
            spans.setdefault(key, [st, t.device, []])[2].append(
                (i, t, off, off + t.numel() * t.element_size()))
    streams = set()
    for st, device, items in spans.values():
        lo = min(a for _, _, a, _ in items)
        hi = max(b for _, _, _, b in items)
        raw = torch.empty(0, dtype=torch.uint8, device=device)
        raw.set_(st, 0, (st.nbytes(),), (1,))
        host = torch.empty(hi - lo, dtype=torch.uint8, pin_memory=True)
        # queued after the caller's kernels on its stream
        host.copy_(raw[lo:hi], non_blocking=True)
        streams.add(torch.cuda.current_stream(device))
        for i, t, a, b in items:
            part = host[a - lo:b - lo].view(t.dtype).view(t.shape)
            out[i] = _tensor_leaf(part)
    for stream in streams:
        stream.synchronize()
    return out


def _parallel(fn: Callable, items: list) -> list:
    """[fn(x) for x in items] on up to _IO_THREADS threads, in order; the
    first exception (in item order) is raised once every call is done."""
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(_IO_THREADS, len(items))) as pool:
        return list(pool.map(fn, items))


def _is_array_leaf(obj) -> bool:
    if torch.is_tensor(obj) or isinstance(obj, (np.ndarray, np.generic)):
        return True
    return hasattr(obj, "shape") and hasattr(obj, "dtype") \
        and not isinstance(obj, (dict, list, tuple))


def _encode(obj, leaves: list):
    """State tree -> JSON skeleton + ordered array leaves (unconverted)."""
    if _is_array_leaf(obj):
        leaves.append(obj)
        return {"k": "a", "i": len(leaves) - 1}
    if isinstance(obj, dict):
        return {"k": "d", "v": {str(k): _encode(v, leaves)
                                for k, v in obj.items()}}
    if isinstance(obj, tuple):
        return {"k": "t", "v": [_encode(v, leaves) for v in obj]}
    if isinstance(obj, list):
        return {"k": "l", "v": [_encode(v, leaves) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"k": "p", "v": obj}
    raise TypeError(f"checkpoint state has unsupported leaf type "
                    f"{type(obj).__name__}")


def _to_leaves(raw: list, copy: bool) -> List[_Leaf]:
    """Host `_Leaf`s of the encoded leaves, in order."""
    out: List[Optional[_Leaf]] = [None] * len(raw)
    idx = [i for i, x in enumerate(raw) if torch.is_tensor(x)]
    for i, leaf in zip(idx, _host_copies([raw[i] for i in idx], copy)):
        out[i] = leaf
    for i, x in enumerate(raw):
        if out[i] is None:
            out[i] = _np_leaf(x, copy)
    return out


def _decode(skel, leaves: List[Any]):
    kind = skel["k"]
    if kind == "a":
        return leaves[skel["i"]]
    if kind == "d":
        return {k: _decode(v, leaves) for k, v in skel["v"].items()}
    if kind == "t":
        return tuple(_decode(v, leaves) for v in skel["v"])
    if kind == "l":
        return [_decode(v, leaves) for v in skel["v"]]
    if kind == "p":
        return skel["v"]
    raise CheckpointCorrupt(f"unknown skeleton kind {kind!r}")


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _read_tensor(path: str, entry: Dict[str, Any]) -> torch.Tensor:
    """One array file as a host torch tensor (bf16 through its words)."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        f.readinto(buf)
    name = entry["dtype"]
    shape = tuple(entry["shape"])
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(name))
                            .reshape(shape))


def _fsync_file(f):
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str):
    """A durable rename needs the parent directory synced too (best-effort
    on filesystems without O_DIRECTORY support)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


class RestoredCheckpoint:
    """restore_latest() result: committed step, state tree, user meta."""

    def __init__(self, step: int, state: Any, meta: Dict, path: str):
        self.step = step
        self.state = state
        self.meta = meta
        self.path = path

    def __repr__(self):  # pragma: no cover
        return f"RestoredCheckpoint(step={self.step}, path={self.path!r})"


class CheckpointManager:
    """Crash-consistent save/restore over a checkpoint root directory.

    Args:
        root: directory holding all `step_*` checkpoints.
        keep_last_n: committed checkpoints retained by GC (the newest valid
            checkpoint is NEVER removed regardless of this value).
        backend: "npy" (raw array files + crc32 checksums).
        async_save: snapshot on the caller's thread, write and commit on a
            background thread (see the module note).
        store / world_size: the multi-rank commit, not ported yet (any
            other than None / 1 raises); `world_size` stays 1 for the
            trainer's world-size check.
    """

    def __init__(self, root: str, keep_last_n: int = 3, backend: str = "npy",
                 async_save: bool = False, store=None, world_size: int = 1):
        if backend in ("orbax", "sharded"):
            raise NotImplementedError(
                f"checkpoint backend {backend!r} is not ported yet (ROADMAP "
                f"queue 1: the distributed slice)")
        if backend != "npy":
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        if store is not None or int(world_size) != 1:
            raise NotImplementedError(
                "the store-synchronised multi-rank commit is not ported yet "
                "(ROADMAP queue 1: the distributed slice)")
        self.root = os.path.abspath(root)
        self.keep_last_n = max(int(keep_last_n), 1)
        self.backend = backend
        self.async_save = bool(async_save)
        self.world_size = 1
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_scan_report: List[Tuple[str, str]] = []  # (path, reason)
        os.makedirs(self.root, exist_ok=True)

    # -- naming ------------------------------------------------------------
    def _dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step):08d}")

    def all_steps(self) -> List[int]:
        """Committed step numbers, ascending (validity not yet checked)."""
        steps = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:  # pragma: no cover
            return []
        for name in names:
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[Dict] = None,
             asynchronous: Optional[bool] = None):
        """Write the checkpoint for `step`; commit atomically; GC old ones.

        Any crash (or injected fault) before the commit rename leaves the
        previous checkpoints untouched; a crash after it at worst skips GC.
        With `asynchronous` (default: the manager's `async_save`) the state
        is snapshotted to host memory before this returns and the write
        and commit run on a background thread; `wait()` (or the next
        `save()`) blocks until the commit and surfaces any error."""
        if asynchronous is None:
            asynchronous = self.async_save
        self.wait()  # one in-flight save at a time; ordered commits
        raw: list = []
        skeleton = _encode(state, raw)
        leaves = _to_leaves(raw, copy=asynchronous)
        if not asynchronous:
            return self._write_npy(step, skeleton, leaves, meta)
        meta = json.loads(json.dumps(meta or {}))  # freeze user meta too
        self._error = None

        def _worker():
            try:
                self._write_npy(step, skeleton, leaves, meta)
            except BaseException as e:  # surfaced at wait()/next save()
                self._error = e

        self._thread = threading.Thread(
            target=_worker, name="ckpt-save", daemon=True)
        self._thread.start()
        return self._dir_for(step)

    def wait(self):
        """Block until the in-flight async save (if any) commits; re-raise
        its error. Idempotent; no-op when nothing is pending."""
        t = self._thread
        if t is None:
            return
        t.join()
        self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write_npy(self, step: int, skeleton, leaves: List[_Leaf],
                   meta: Optional[Dict]):
        final = self._dir_for(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):  # stale debris from a previous crash
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        chaos.crash_point("ckpt.begin")

        def write(item):
            i, leaf = item
            fname = f"arr_{i}.bin"
            buf = leaf.words()
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(buf)
                _fsync_file(f)
            entry = {
                "file": fname,
                "shape": list(leaf.array.shape),
                "dtype": leaf.dtype,
                "crc32": zlib.crc32(buf) & 0xFFFFFFFF,
            }
            chaos.crash_point("ckpt.array")
            return entry

        with _span("ckpt.write", cat="io", args={"step": int(step)}):
            arrays = _parallel(write, list(enumerate(leaves)))
        return self._finalize(step, tmp, final, skeleton, arrays, meta)

    def _finalize(self, step: int, tmp: str, final: str, skeleton, arrays,
                  meta: Optional[Dict]):
        try:
            out = self._finalize_inner(step, tmp, final, skeleton, arrays,
                                       meta)
        except BaseException:
            _SAVES.inc(outcome="failed")
            raise
        _SAVES.inc(outcome="committed")
        return out

    def _finalize_inner(self, step: int, tmp: str, final: str, skeleton,
                        arrays, meta: Optional[Dict]):
        chaos.crash_point("ckpt.before_manifest")
        manifest = {
            "version": _FORMAT_VERSION,
            "step": int(step),
            "backend": self.backend,
            "meta": meta or {},
            "skeleton": skeleton,
            "arrays": arrays,
        }
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
            _fsync_file(f)
        os.replace(mpath + ".tmp", mpath)
        _fsync_dir(tmp)

        chaos.crash_point("ckpt.before_commit")
        self._commit_rename(step, tmp, final)

        chaos.crash_point("ckpt.before_gc")
        self._gc()
        return final

    def _commit_rename(self, step: int, tmp: str, final: str) -> None:
        with _span("ckpt.commit", cat="io", args={"step": int(step)}):
            if os.path.exists(final):  # same-step re-save: replace atomically
                old = final + ".replaced"
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old)
            else:
                os.rename(tmp, final)  # <- the commit point
            _fsync_dir(self.root)

    # -- GC ----------------------------------------------------------------
    def _gc(self):
        """Delete committed checkpoints beyond keep_last_n (oldest first) and
        any stale `.tmp` debris. The newest VALID checkpoint is never
        deleted: keepers are counted from validated directories, so a
        corrupt newest cannot shadow the good one into deletion."""
        for name in os.listdir(self.root):
            full = os.path.join(self.root, name)
            if name.endswith((".tmp", ".replaced")) and os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
        steps = self.all_steps()
        valid_kept = 0
        keep: set = set()
        for s in reversed(steps):  # newest first
            if valid_kept < self.keep_last_n \
                    and self.validate(self._dir_for(s)) is None:
                keep.add(s)
                valid_kept += 1
        if valid_kept == 0:
            return  # nothing provably good: delete nothing
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._dir_for(s), ignore_errors=True)

    # -- validation / restore ---------------------------------------------
    def validate(self, path: str) -> Optional[str]:
        """None if `path` is a complete, checksum-valid checkpoint; otherwise
        a human-readable corruption reason."""
        mpath = os.path.join(path, MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            return "missing manifest"
        except (OSError, json.JSONDecodeError) as e:
            return f"unreadable manifest: {e}"
        if manifest.get("version") != _FORMAT_VERSION:
            return f"unsupported version {manifest.get('version')!r}"
        if manifest.get("backend", "npy") != "npy":
            return (f"backend {manifest.get('backend')!r} is not ported "
                    f"yet")
        entries = list(manifest.get("arrays", ()))

        def crc(entry):
            try:
                return _crc32_file(os.path.join(path, entry["file"]))
            except OSError:
                return None

        for entry, got in zip(entries, _parallel(crc, entries)):
            if got is None:
                return f"missing array file {entry['file']}"
            if got != entry["crc32"]:
                return f"checksum mismatch in {entry['file']}"
        return None

    def _load(self, path: str, template: Optional[Any]) -> Tuple[Any, Dict]:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        leaves = _parallel(
            lambda e: _read_tensor(os.path.join(path, e["file"]), e),
            list(manifest["arrays"]))
        state = _decode(manifest["skeleton"], leaves)
        if template is not None:
            state = _place_like(state, template)
        return state, manifest.get("meta", {})

    def restore_latest(self, template: Optional[Any] = None
                       ) -> Optional[RestoredCheckpoint]:
        """Newest valid checkpoint (validating manifest + checksums), falling
        back to older ones on corruption; None when nothing valid exists.
        `template` (a tree of tensors matching the saved structure) places
        each restored leaf on its template leaf's device."""
        self.wait()  # a just-issued async save must be visible (or raise)
        self.last_scan_report = []
        for step in reversed(self.all_steps()):
            path = self._dir_for(step)
            reason = self.validate(path)
            if reason is not None:
                self.last_scan_report.append((path, reason))
                continue
            try:
                state, meta = self._load(path, template)
            except Exception as e:  # torn beyond what validate caught
                self.last_scan_report.append((path, f"load failed: {e}"))
                continue
            return RestoredCheckpoint(step, state, meta, path)
        return None


def _place_like(state, template):
    """Pair restored leaves with template leaves: a tensor template puts
    its leaf on the template's device (the stored dtype is kept)."""
    if torch.is_tensor(template):
        return state.to(template.device) if torch.is_tensor(state) \
            else state
    if isinstance(template, dict):
        return {k: _place_like(state[k], template[k]) if k in template
                else state[k] for k in state}
    if isinstance(template, (list, tuple)):
        out = [_place_like(s, t) for s, t in zip(state, template)]
        return tuple(out) if isinstance(template, tuple) else out
    return state
