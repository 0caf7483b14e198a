"""Data feeds (counterpart of paddle_tpu/io): packed pretraining batches."""
from .packing import IGNORE_LABEL, PackedLMBatches, pack_examples

__all__ = ["IGNORE_LABEL", "PackedLMBatches", "pack_examples"]
