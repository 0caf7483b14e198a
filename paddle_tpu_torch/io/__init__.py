"""Data feeds (counterpart of paddle_tpu/io): datasets, samplers, the
DataLoader with inline, thread and forked process workers over shared
memory, the DevicePrefetcher that overlaps the host-to-device copy with
compute, and packed pretraining batches. `InMemoryDataset` waits for a
later slice."""
from .dataloader import DataLoader, default_collate_fn, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .packing import IGNORE_LABEL, PackedLMBatches, pack_examples
from .prefetch import DevicePrefetcher, maybe_prefetch
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = [
    "DataLoader", "default_collate_fn", "get_worker_info", "ChainDataset",
    "ComposeDataset", "ConcatDataset", "Dataset", "IterableDataset",
    "Subset", "TensorDataset", "random_split", "IGNORE_LABEL",
    "PackedLMBatches", "pack_examples", "DevicePrefetcher",
    "maybe_prefetch", "BatchSampler", "DistributedBatchSampler",
    "RandomSampler", "Sampler", "SequenceSampler", "SubsetRandomSampler",
    "WeightedRandomSampler",
]
