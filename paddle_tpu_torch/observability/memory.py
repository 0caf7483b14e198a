"""Memory gauges: the card's allocator and the host process (counterpart
of paddle_tpu/observability/memory.py over torch.cuda in place of
jax.local_devices(); the reference's per-executable XLA cost and memory
analysis has no counterpart in an eager port).

  * device: per CUDA device, torch.cuda.memory_stats() (bytes allocated
    and reserved now and at peak) and torch.cuda.mem_get_info() (free and
    total bytes on the card, what every process there leaves);
  * host: this process's RSS (/proc/self/statm) and peak RSS
    (getrusage).

The gauges exist whatever the device, so a scrape is shaped alike on a
machine without a card. "Are we about to run out" is
device_memory_bytes{kind="bytes_free"} against {kind="bytes_limit"}.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import torch

from .registry import gauge

_DEV_G = gauge("device_memory_bytes",
               "Per-device memory (allocated, reserved and their peaks "
               "from torch.cuda.memory_stats(); free and limit from "
               "torch.cuda.mem_get_info()).",
               labelnames=("device", "kind"))
_HOST_G = gauge("host_memory_bytes",
                "Host process memory (rss = live, peak_rss = high water).",
                labelnames=("kind",))

# memory_stats() key -> gauge label
_STAT_KEYS = {"allocated_bytes.all.current": "bytes_in_use",
              "allocated_bytes.all.peak": "peak_bytes_in_use",
              "reserved_bytes.all.current": "bytes_reserved",
              "reserved_bytes.all.peak": "peak_bytes_reserved"}


def host_memory_bytes() -> Dict[str, int]:
    """Live RSS and peak RSS of this process (zeros where unsupported)."""
    out = {"rss": 0, "peak_rss": 0}
    try:
        with open("/proc/self/statm") as f:
            out["rss"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        out["peak_rss"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024    # KiB on Linux
    except ImportError:
        pass
    return out


def device_memory_stats() -> List[Dict[str, Any]]:
    """One entry per CUDA device the process sees (none without a card):
    its name and the byte counts above."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        row = {"device": str(i), "kind": torch.cuda.get_device_name(i)}
        for key, label in _STAT_KEYS.items():
            row[label] = int(stats.get(key, 0))
        free, total = torch.cuda.mem_get_info(i)
        row["bytes_free"], row["bytes_limit"] = int(free), int(total)
        out.append(row)
    return out


def update_memory_gauges() -> Dict[str, Any]:
    """Refresh device_memory_bytes and host_memory_bytes; returns the
    summary."""
    summary: Dict[str, Any] = {"ts": time.time(), "devices": [], "host": {}}
    for row in device_memory_stats():
        for k, v in row.items():
            if k not in ("device", "kind"):
                _DEV_G.set(v, device=row["device"], kind=k)
        summary["devices"].append(row)
    host = host_memory_bytes()
    for k, v in host.items():
        _HOST_G.set(v, kind=k)
    summary["host"] = host
    return summary
