"""Data pipeline: the datamodule protocol and numpy loaders.

A copy of ``ray_lightning_tpu/core/data.py`` (numpy only, not imported
from the JAX package): loaders yield numpy batches; moving them to the
device is the loop's job.  Host sharding is kept so both packages draw the
same batches; the port's single-device fit uses one shard.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["TpuDataModule", "ArrayDataset", "RandomDataset",
           "NumpyLoader"]


class TpuDataModule:
    """≙ ``pl.LightningDataModule``.  Subclasses override the
    ``*_dataloader`` methods; :meth:`set_shard` runs before ``setup``."""

    def __init__(self):
        self.shard_index: int = 0
        self.num_shards: int = 1

    def set_shard(self, shard_index: int, num_shards: int) -> None:
        self.shard_index = shard_index
        self.num_shards = num_shards

    def prepare_data(self) -> None:
        """Once-per-node work."""

    def setup(self, stage: str) -> None:
        ...

    def train_dataloader(self):
        raise NotImplementedError

    def val_dataloader(self):
        return None

    def test_dataloader(self):
        return None

    def predict_dataloader(self):
        return None

    def teardown(self, stage: str) -> None:
        ...


class _ModuleDataModule(TpuDataModule):
    """Adapter: a module that builds its own loaders (Lightning-style
    ``*_dataloader`` methods) as a datamodule; its loaders get the host
    shard."""

    def __init__(self, module):
        super().__init__()
        self._module = module

    def _loader(self, name: str):
        fn = getattr(self._module, name, None)
        loader = fn() if fn is not None else None
        if loader is not None and hasattr(loader, "set_shard"):
            loader.set_shard(self.shard_index, self.num_shards)
        return loader

    def train_dataloader(self):
        return self._loader("train_dataloader")

    def val_dataloader(self):
        return self._loader("val_dataloader")

    def test_dataloader(self):
        return self._loader("test_dataloader")

    def predict_dataloader(self):
        return self._loader("predict_dataloader")


class ArrayDataset:
    """A dataset over aligned numpy arrays."""

    def __init__(self, **arrays: np.ndarray):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError(f"Array length mismatch: {sizes}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.size = next(iter(sizes.values())) if sizes else 0

    def __len__(self) -> int:
        return self.size

    def take(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class RandomDataset(ArrayDataset):
    """Synthetic regression data: ``length`` rows of ``size`` standard
    normal f32 features under key ``x``, drawn from ``seed`` (the JAX
    package's ``RandomDataset``, the same numpy draws)."""

    def __init__(self, size: int = 32, length: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        super().__init__(
            x=rng.standard_normal((length, size), dtype=np.float32))


class NumpyLoader:
    """Batched iterator over an :class:`ArrayDataset` with host sharding:
    each step yields this shard's ``batch_size // num_shards`` rows of the
    global batch, in an order (``seed + epoch`` when shuffled) that is the
    same on every shard.  A ragged last batch is dropped by default."""

    def __init__(self, dataset: ArrayDataset, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1, drop_last: bool = True):
        if batch_size % num_shards != 0:
            raise ValueError(
                f"Global batch_size {batch_size} must divide evenly over "
                f"{num_shards} host shards.")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """≙ ``DistributedSampler.set_epoch``: reshuffle per epoch."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        for b in range(len(self)):
            global_idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            per = len(global_idx) // self.num_shards
            lo = self.shard_index * per
            yield self.dataset.take(global_idx[lo:lo + per])
