"""Data loaders (port of ``deepspeed_tpu/runtime/dataloader.py``:
``RepeatingLoader :30``, ``default_collate :52``, ``DeepSpeedDataLoader
:141``).

Datasets are sequences of samples: numpy arrays, tensors, or tuples and
dicts of them. Batches stack to torch tensors on the host, and the engine
moves them to its device. Shuffling draws the same numpy
``default_rng(seed + epoch)`` permutation as the JAX loader, so batch for
batch both loaders yield the same samples. Not ported yet:
``DevicePrefetchIterator`` and ``PrefetchingLoader`` (``async_pipeline``)
and the curriculum sampler.
"""

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch


class RepeatingLoader:

    def __init__(self, loader):
        """Wraps an iterator to restart on StopIteration."""
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def default_collate(items):
    """Stack a list of samples into tensors; supports tuples, dicts and
    arrays (a tuple or list of samples collates to a tuple)."""
    first = items[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([it[i] for it in items]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    return torch.stack([torch.as_tensor(np.asarray(it)) for it in items])


class DeepSpeedDataLoader:
    """Batched loader over a map-style dataset: ``batch_size`` samples a
    batch, the last partial batch dropped with ``drop_last``, shuffled
    anew each epoch (``set_epoch``) when ``shuffle``."""

    def __init__(self,
                 dataset: Sequence,
                 batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False,
                 seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) / self.batch_size
        return math.floor(n) if self.drop_last else math.ceil(n)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in sel])
