"""Datasets and the loader, the parts ``hapi.Model.fit`` uses.

Port of ``paddle_tpu/io/__init__.py``: ``TensorDataset`` and
``DataLoader`` over it with ``batch_size``, ``shuffle`` and
``drop_last``. A batch is a list with one tensor per dataset tensor,
gathered with one ``index_select`` each, on the device the dataset's
tensors live on. Shuffling draws a permutation from a
``torch.Generator`` the caller passes (``generator=``), or from a fresh
one seeded with the epoch number, so an epoch's order is reproducible.
Not ported yet: other datasets and samplers, ``collate_fn``, workers and
the device prefetcher.
"""

from __future__ import annotations

import torch

__all__ = ["TensorDataset", "DataLoader"]


class TensorDataset:
    """Rows of equally long tensors: item ``i`` is ``(t[i] for t in
    tensors)``."""

    def __init__(self, tensors):
        self.tensors = list(tensors)
        n = {t.shape[0] for t in self.tensors}
        if len(n) != 1:
            raise ValueError(f"TensorDataset: tensors of different lengths "
                             f"{sorted(n)}")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class DataLoader:
    """Batches of a :class:`TensorDataset`: ``batch_size`` rows each, in
    order or (``shuffle``) in a permuted order; the last short batch is
    kept unless ``drop_last``."""

    def __init__(self, dataset, batch_size=1, shuffle=False,
                 drop_last=False, generator=None):
        if not isinstance(dataset, TensorDataset):
            raise TypeError("the port's DataLoader takes a TensorDataset")
        if batch_size < 1:
            raise ValueError(f"batch_size={batch_size} must be >= 1")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.generator = generator
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self):
        n = len(self.dataset)
        if not self.shuffle:
            return torch.arange(n)
        gen = self.generator
        if gen is None:
            gen = torch.Generator().manual_seed(self._epoch)
        return torch.randperm(n, generator=gen)

    def __iter__(self):
        # the order moves to the data's device once an epoch: a copy per
        # batch would wait for the device to finish the step before
        order = self._order().to(self.dataset.tensors[0].device)
        self._epoch += 1
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield [t.index_select(0, idx) for t in self.dataset.tensors]
