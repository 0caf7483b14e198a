"""Launch counting for the kernel wrappers.

A wrapper calls `count(wrapper)` where it launches its kernel. The count
lands on the wrapper's plain int attribute, `<wrapper>.launches`, shared by
every thread. While a thread is inside `recording()` (a CUDA graph capture:
the launches are recorded into the graph, not made), its counts go to the
recorder instead, so a capture in one thread never absorbs the launches of
another thread's replays or eager calls.
"""
import contextlib
import threading

_lock = threading.Lock()
_local = threading.local()


def count(wrapper) -> None:
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec[wrapper] = rec.get(wrapper, 0) + 1
        return
    with _lock:
        wrapper.launches += 1


def add(wrapper, n: int) -> None:
    with _lock:
        wrapper.launches += int(n)


@contextlib.contextmanager
def recording():
    """Divert this thread's counts into the yielded {wrapper: launches}
    dict for the body of the block."""
    outer = getattr(_local, "rec", None)
    _local.rec = rec = {}
    try:
        yield rec
    finally:
        _local.rec = outer
