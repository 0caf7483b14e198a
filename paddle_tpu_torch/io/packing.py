"""Packed variable-length batches for causal-LM pretraining (counterpart of
paddle_tpu/io/packing.py).

Documents stream into fixed [rows, capacity] int32 buffers; each token
carries the id of its document within the row (restarting at 0 in every
row) and padding carries -1, so segmented attention keeps documents apart
and the loss masks pairs that cross a boundary. Labels are the ids with
IGNORE_LABEL at padding. The reference packs through its native
`pt_pack_varlen` when that library is built and through `_pack_numpy`
otherwise, which mirrors it exactly; packing is host code, so the port keeps
its own copy of `_pack_numpy` and uses it always.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

__all__ = ["pack_examples", "PackedLMBatches", "IGNORE_LABEL"]

IGNORE_LABEL = -100


def _pack_numpy(docs: Sequence[np.ndarray], capacity: int,
                pad_id: int,
                split_docs: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    rows_ids: List[List[int]] = [[]]
    rows_seg: List[List[int]] = [[]]
    seg = 0
    for d in docs:
        d = np.asarray(d, np.int32).ravel()
        off = 0
        if (not split_docs and rows_ids[-1]
                and len(d) > capacity - len(rows_ids[-1])):
            rows_ids.append([])
            rows_seg.append([])
            seg = 0
        while off < len(d):
            if len(rows_ids[-1]) == capacity:
                rows_ids.append([])
                rows_seg.append([])
                seg = 0
            take = min(capacity - len(rows_ids[-1]), len(d) - off)
            rows_ids[-1].extend(d[off:off + take].tolist())
            rows_seg[-1].extend([seg] * take)
            off += take
            if off >= len(d):
                seg += 1
    ids = np.full((len(rows_ids), capacity), pad_id, np.int32)
    segm = np.full((len(rows_ids), capacity), -1, np.int32)
    for r, (ri, rs) in enumerate(zip(rows_ids, rows_seg)):
        ids[r, :len(ri)] = ri
        segm[r, :len(rs)] = rs
    return ids, segm


def pack_examples(docs: Sequence, capacity: int, pad_id: int = 0,
                  split_docs: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack token documents into fixed rows. Returns (ids, segments,
    labels), each [rows, capacity]: ids and segments int32, labels int64
    with IGNORE_LABEL at padding. split_docs=True cuts documents at row
    boundaries (densest); False keeps each document whole in one row."""
    ids, seg = _pack_numpy(docs, capacity, pad_id, split_docs)
    labels = np.where(seg >= 0, ids, IGNORE_LABEL).astype(np.int64)
    return ids, seg, labels


class PackedLMBatches:
    """Iterate (ids, segments, labels) batches of `batch_rows` packed rows
    from a stream of token documents: the pretraining feed for
    `model(ids, labels=labels, segments=segments)` and for TrainStep."""

    def __init__(self, docs: Iterable, capacity: int, batch_rows: int,
                 pad_id: int = 0, drop_last: bool = True,
                 split_docs: bool = True):
        self.docs = docs
        self.capacity = int(capacity)
        self.batch_rows = int(batch_rows)
        self.pad_id = pad_id
        self.drop_last = drop_last
        self.split_docs = split_docs

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]]:
        """Documents are pulled from the source in chunks of about two
        batches' worth of tokens and packed as they arrive; packed rows
        carry over to the next chunk, so nothing is dropped mid-stream. A
        one-shot generator source raises on a second pass instead of
        yielding nothing."""
        it = iter(self.docs)
        chunk_tokens = self.capacity * self.batch_rows
        pending: list = []
        pending_tok = 0
        rows: list = []
        yielded = False

        def pack_pending():
            ids, seg, labels = pack_examples(pending, self.capacity,
                                             self.pad_id,
                                             split_docs=self.split_docs)
            rows.extend(zip(ids, seg, labels))

        def drain(final=False):
            while len(rows) >= self.batch_rows or (
                    final and rows and not self.drop_last):
                take = rows[:self.batch_rows]
                del rows[:self.batch_rows]
                yield (np.stack([t[0] for t in take]),
                       np.stack([t[1] for t in take]),
                       np.stack([t[2] for t in take]))

        for doc in it:
            pending.append(doc)
            pending_tok += len(doc)
            if pending_tok >= 2 * chunk_tokens:
                pack_pending()
                pending, pending_tok = [], 0
                for out in drain():
                    yielded = True
                    yield out
        if pending:
            pack_pending()
        for out in drain(final=True):
            yielded = True
            yield out
        if not yielded and iter(self.docs) is it:
            raise RuntimeError(
                "PackedLMBatches source is an exhausted one-shot "
                "generator (second epoch?); pass a re-iterable (list, "
                "Dataset) for multi-epoch training")
