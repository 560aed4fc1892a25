"""``io``: datasets, samplers, collate and the loader with its workers.
The port of ``paddle_tpu/io/__init__.py``.

**Datasets.** ``Dataset``, ``IterableDataset``, ``TensorDataset``,
``ComposeDataset``, ``ChainDataset``, ``ConcatDataset``, ``Subset`` and
``random_split``.

**Samplers.** ``SequenceSampler``, ``RandomSampler``,
``WeightedRandomSampler``, ``BatchSampler``, ``DistributedBatchSampler``
and ``SubsetRandomSampler`` draw from numpy ``RandomState``\\ s with the
JAX package's seeds, so their index streams are the JAX package's, index
for index (``RandomSampler``'s epoch ``e`` of a sampler's life draws
from ``RandomState(12345 + e)``; ``WeightedRandomSampler`` from numpy's
global generator, as there).

**Collate.** ``default_collate_fn`` stacks tensors, numpy arrays and
numbers into torch tensors, recursing into dicts, lists and tuples
(strings stay lists); ``default_convert_fn`` converts without stacking
(the collate of ``batch_size=None``).

**The TensorDataset fast path.** A ``DataLoader`` over a
``TensorDataset`` with no ``batch_sampler`` and no ``collate_fn``
gathers each batch with one ``index_select`` per tensor on the device
the tensors live on, in order or in a permutation from ``generator=``
or from a generator seeded with the epoch number. Its workers would
have nothing to do (the data is already on the device), so
``num_workers`` is not used there.

**Workers** (``num_workers > 0`` over any other map-style dataset):
``num_workers`` processes take ``(epoch, batch, indices)`` jobs from an
index queue and return collated batches, which the loader hands out
strictly in the batch sampler's order with a bounded window
(``num_workers * prefetch_factor``). A worker sends its batch pickled by
value (no shared-memory handles), on the CPU: a worker never touches
CUDA. An exception in a worker is re-raised in the loader with its type;
a worker that dies raises ``_WorkersDied`` naming it and its exit code;
``timeout`` bounds the wait for a batch; ``worker_init_fn(worker_id)``
runs once in each worker, where ``get_worker_info()`` describes it;
``persistent_workers`` keeps the processes across epochs.

The start method is ``forkserver``. The server is a fresh interpreter
that imports this module (and torch) once; each worker is forked from
it. So a worker inherits no CUDA context and none of the trainer's
threads (``fork`` from a trainer that holds a CUDA context is safe only
while the child never touches CUDA, and forking a threaded process can
deadlock), and it still starts without importing torch anew
(``spawn`` pays that import, seconds, in every worker of every epoch).
As with ``spawn``, the dataset, the ``collate_fn`` and the
``worker_init_fn`` are pickled to the workers: when they cannot be, the
loader warns and falls back to a pool of threads (as it does when every
worker dies at start-up with exit code 1, the shape of a dataset that
cannot be unpickled in a fresh interpreter). An ``IterableDataset``
streams through one background thread.

Not ported yet: the device prefetcher (``DevicePrefetcher``,
``prefetch_to_device=``, ``device_sharding=``), which comes with the
graphed step.
"""

from __future__ import annotations

import collections
import itertools
import math
import multiprocessing
import os
import pickle
import queue
import threading
import time
import traceback
import warnings
import weakref

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "WeightedRandomSampler", "DistributedBatchSampler",
           "SubsetRandomSampler", "DataLoader", "get_worker_info",
           "default_collate_fn", "default_convert_fn"]


# ---- datasets -------------------------------------------------------------

class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
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


class ComposeDataset(Dataset):
    """Item ``i`` is the items ``i`` of every dataset, flattened one
    level."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            if isinstance(item, (list, tuple)):
                out.extend(item)
            else:
                out.append(item)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cum[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``\\ s of the given lengths (or fractions) over a
    permutation from ``RandomState(0)``, or over ``generator`` when it is
    given (the permutation itself, as in the JAX package)."""
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * f)) for f in lengths]
        lengths[-1] += n - sum(lengths)
    total = sum(lengths)
    perm = np.random.RandomState(0).permutation(total) if generator is None \
        else np.asarray(generator)
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l].tolist()))
        off += l
    return out


# ---- samplers -------------------------------------------------------------

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, draws) per epoch; the
    epoch-th iteration of a sampler draws from ``RandomState(12345 +
    epoch)``."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        self._epoch_seed = itertools.count()

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState(next(self._epoch_seed) + 12345)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def data_replicas():
    """``(replicas, rank)`` of the data the ranks read apart: with a
    ``fleet`` topology its ``data`` x ``sharding`` ranks (the ranks of a
    ``model``, ``sep``, ``pipe`` or ``expert`` group read the same batch),
    else the process group's world;
    without a process group the launcher's ``PADDLE_TRAINERS_NUM`` /
    ``PADDLE_TRAINER_ID``."""
    import sys
    import torch.distributed as dist
    root = __package__.rpartition(".")[0]
    base = sys.modules.get(root + ".distributed.fleet.base")
    hcg = base.current_hcg() if base is not None else None
    if hcg is not None:
        sh = hcg.get_sharding_parallel_world_size()
        return (hcg.get_data_parallel_world_size() * sh,
                hcg.get_data_parallel_rank() * sh
                + hcg.get_sharding_parallel_rank())
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return (int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
            int(os.environ.get("PADDLE_TRAINER_ID", "0")))


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset over ``num_replicas`` data-parallel ranks (the
    indices padded by wrapping to a multiple of the ranks); ``shuffle``
    permutes with ``RandomState(epoch)``, the epoch set by
    :meth:`set_epoch`. Without ``num_replicas``/``rank`` they come from
    the process group once one is initialised (:func:`data_replicas`),
    else from ``PADDLE_TRAINERS_NUM``/``PADDLE_TRAINER_ID`` (the
    launcher's)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            n, r = data_replicas()
            num_replicas = n if num_replicas is None else num_replicas
            rank = r if rank is None else rank
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class SubsetRandomSampler(Sampler):
    """The given indices in a random order, per epoch from
    ``RandomState(12345 + epoch)`` as :class:`RandomSampler`."""

    def __init__(self, indices):
        self.indices = list(indices)
        self._epoch_seed = itertools.count()

    def __iter__(self):
        rng = np.random.RandomState(next(self._epoch_seed) + 12345)
        return iter([self.indices[i]
                     for i in rng.permutation(len(self.indices))])

    def __len__(self):
        return len(self.indices)


# ---- collate --------------------------------------------------------------

def default_collate_fn(batch):
    """Stack a list of samples into a batch of torch tensors: tensors
    with ``torch.stack``, numpy arrays and numbers through numpy (its
    dtype kept), dicts per key, lists and tuples per position; strings
    and bytes stay a list, anything else is returned as given."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(list(batch))
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(list(batch)))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch])
                for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    return batch


def default_convert_fn(batch):
    """Convert without stacking (``DataLoader(batch_size=None)``): numpy
    arrays and scalars to tensors, recursing into containers."""
    if isinstance(batch, torch.Tensor):
        return batch
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    if isinstance(batch, (np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(batch, (int, float)):
        return batch
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(default_convert_fn(b) for b in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(default_convert_fn(b) for b in batch)
    if isinstance(batch, dict):
        return {k: default_convert_fn(v) for k, v in batch.items()}
    return batch


# ---- workers --------------------------------------------------------------

class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    """In a loader worker (process or thread): its ``id``,
    ``num_workers`` and ``dataset``; None elsewhere."""
    return getattr(_worker_info, "info", None)


class _WorkersDied(RuntimeError):
    """Worker processes exited without a result: carries the first dead
    worker's id and exit code (``worker_id``, ``exitcode``), every dead
    one (``dead``) and the last traceback a worker forwarded."""

    def __init__(self, dead=(), last_tb=None, all_dead=False):
        self.dead = list(dead)            # [(worker_id, exitcode)]
        self.last_tb = last_tb
        self.all_dead = bool(all_dead)
        wid, code = (self.dead[0] if self.dead else (None, None))
        self.worker_id = wid
        self.exitcode = code
        msg = (f"DataLoader worker {wid} exited unexpectedly "
               f"(exit code {code}"
               + (", likely killed — e.g. OOM" if isinstance(code, int)
                  and code < 0 else "") + ")"
               if self.dead else
               "DataLoader worker processes exited unexpectedly")
        if len(self.dead) > 1:
            msg += f"; {len(self.dead)} workers dead: {self.dead}"
        if last_tb:
            msg += f"\nlast worker traceback:\n{last_tb}"
        super().__init__(msg)


_CRASH = "__worker_crash__"


def _worker_loop(dataset, index_q, result_q, collate, wid, num_workers,
                 worker_init_fn):
    """A worker process: ``(epoch, batch, indices)`` jobs in, ``(epoch,
    batch, ok, payload)`` out, the payload a pickled batch or the
    ``(exception, traceback)`` of a failed one."""
    try:
        torch.set_num_threads(1)    # the workers share the trainer's cores
        _worker_info.info = _WorkerInfo(wid, num_workers, dataset)
        if worker_init_fn is not None:
            worker_init_fn(wid)
        while True:
            job = index_q.get()
            if job is None:
                return
            epoch, bidx, indices = job
            try:
                out = pickle.dumps(collate([dataset[i] for i in indices]),
                                   protocol=pickle.HIGHEST_PROTOCOL)
                result_q.put((epoch, bidx, True, out))
            except Exception as e:  # noqa: BLE001 — re-raised in the loader
                try:
                    pickle.dumps(e)
                    payload = (e, traceback.format_exc())
                except Exception:  # noqa: BLE001
                    payload = (None, traceback.format_exc())
                result_q.put((epoch, bidx, False, payload))
    except BaseException:
        # a crash of the loop itself: forward the traceback so that the
        # loader can attribute the death, then die
        try:
            result_q.put((_CRASH, wid, traceback.format_exc()))
        except Exception:  # noqa: BLE001
            pass
        raise


def _context():
    ctx = multiprocessing.get_context("forkserver")
    # the server imports torch once; the workers fork from it
    ctx.set_forkserver_preload(["__main__", __name__])
    return ctx


class _ProcessPool:
    """``num_workers`` worker processes around one index queue and one
    result queue."""

    def __init__(self, dataset, collate, num_workers, worker_init_fn):
        ctx = _context()
        self.index_q = ctx.Queue()
        self.result_q = ctx.Queue()
        self.workers = []
        self.last_crash_tb = None
        try:
            for wid in range(num_workers):
                p = ctx.Process(
                    target=_worker_loop,
                    args=(dataset, self.index_q, self.result_q, collate,
                          wid, num_workers, worker_init_fn),
                    daemon=True)
                p.start()
                self.workers.append(p)
        except Exception:
            self.shutdown()
            raise

    def dead(self):
        """``[(worker_id, exitcode)]`` of the workers that exited."""
        return [(wid, p.exitcode) for wid, p in enumerate(self.workers)
                if not p.is_alive()]

    def shutdown(self):
        for _ in self.workers:
            try:
                self.index_q.put(None)
            except Exception:  # noqa: BLE001
                pass
        for p in self.workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q_ in (self.index_q, self.result_q):
            try:
                q_.close()
                q_.cancel_join_thread()
            except Exception:  # noqa: BLE001
                pass


# ---- the loader -----------------------------------------------------------

class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, generator=None):
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size={batch_size} must be >= 1")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.persistent_workers = persistent_workers
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.generator = generator
        self._epoch = 0
        self._pool = None
        self._pool_active = False  # the persistent pool serves an iterator
        self._pool_owner = None    # weakref to that iterator
        self._mp_broken = False    # workers failed once: threads from now
        self._fast = (isinstance(dataset, TensorDataset)
                      and batch_sampler is None and collate_fn is None
                      and batch_size is not None)
        self._iterable = isinstance(dataset, IterableDataset)
        # batch_size=None: no batching; samples are converted, not stacked
        self._unbatched = batch_size is None and batch_sampler is None
        if self._unbatched and collate_fn is None:
            self.collate_fn = default_convert_fn
        if self._fast or self._iterable or self._unbatched:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no length")
        if self._unbatched:
            return len(self.dataset)
        if self._fast:
            n = len(self.dataset)
            if self.drop_last:
                return n // self.batch_size
            return -(-n // self.batch_size)
        return len(self.batch_sampler)

    def _seed_epochs_from(self, epoch):
        """Make the epoch-th iteration from here draw the order of epoch
        ``epoch``: the fast path seeds its permutation with the epoch
        number; a ``RandomSampler`` (or ``SubsetRandomSampler``) under the
        batch sampler restarts its epoch counter there. ``fit`` calls it
        on the loader it builds, so that a resumed run sees the batches
        of an uninterrupted one."""
        self._epoch = int(epoch)
        sampler = getattr(self.batch_sampler, "sampler", None)
        if hasattr(sampler, "_epoch_seed"):
            sampler._epoch_seed = itertools.count(int(epoch))

    # -- the TensorDataset fast path ------------------------------------

    def _order(self):
        n = len(self.dataset)
        if not self.shuffle:
            return torch.arange(n)
        gen = self.generator
        if gen is None:
            gen = torch.Generator().manual_seed(self._epoch)
        return torch.randperm(n, generator=gen)

    def _iter_fast(self):
        # the order moves to the data's device once an epoch: a copy per
        # batch would wait for the device to finish the step before
        order = self._order().to(self.dataset.tensors[0].device)
        self._epoch += 1
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield [t.index_select(0, idx) for t in self.dataset.tensors]

    # -- batches in this process ----------------------------------------

    def _iter_batches(self):
        if self._iterable:
            if self._unbatched:
                for item in self.dataset:
                    yield self.collate_fn(item)
                return
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self._unbatched:
            for i in range(len(self.dataset)):
                yield self.collate_fn(self.dataset[i])
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self._fast:
            return self._iter_fast()
        if self.num_workers <= 0 or self._unbatched:
            return self._iter_batches()
        if self._iterable:
            return self._iter_prefetch_single()
        if self._mp_broken:
            return self._iter_pool()
        if (self._pool is not None and self._pool_active
                and self._pool_owner is not None
                and self._pool_owner() is None):
            # the iterator that claimed the persistent pool is gone
            # without releasing it: reclaim it
            self._pool_active = False
        owner_box: list = []
        g = self._iter_mp(owner_box)
        owner_box.append(weakref.ref(g))
        return g

    def __del__(self):
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()

    def _iter_prefetch_single(self):
        """An ``IterableDataset``: one background producer thread (the
        stream is sequential), a bounded queue."""
        q: queue.Queue = queue.Queue(
            maxsize=max(self.num_workers * self.prefetch_factor, 1))
        end = object()

        def producer():
            _worker_info.info = _WorkerInfo(0, self.num_workers,
                                            self.dataset)
            try:
                if self.worker_init_fn is not None:
                    self.worker_init_fn(0)
                for b in self._iter_batches():
                    q.put((True, b))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put((False, e))
            finally:
                q.put((True, end))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            ok, b = q.get()
            if not ok:
                raise b
            if b is end:
                break
            yield b
        t.join()

    # -- worker processes -----------------------------------------------

    def _iter_mp(self, owner_box=None):
        pool = self._pool
        # a second live iterator must not share the persistent pool's
        # result queue: it gets a pool of its own for the epoch
        transient = pool is not None and self._pool_active
        if transient:
            pool = None
        if pool is None:
            try:
                pool = _ProcessPool(self.dataset, self.collate_fn,
                                    self.num_workers, self.worker_init_fn)
            except Exception as e:  # noqa: BLE001 — pickling, start-up
                warnings.warn(
                    f"DataLoader: could not start worker processes "
                    f"({type(e).__name__}: {e}); the dataset/collate_fn/"
                    f"worker_init_fn must be picklable. Falling back to "
                    f"a pool of threads.")
                self._mp_broken = True
                yield from self._iter_pool()
                return
        persist = self.persistent_workers and not transient
        if persist:
            self._pool = pool
            self._pool_active = True
            if owner_box:
                self._pool_owner = owner_box[0]
        self._epoch += 1
        epoch = self._epoch
        window = max(self.num_workers * self.prefetch_factor, 1)
        it = iter(self.batch_sampler)
        it_done = False
        submitted = 0
        next_yield = 0
        buf = {}
        fall_back = False

        def refill():
            nonlocal submitted, it_done
            if it_done:
                return
            try:
                pool.index_q.put((epoch, submitted, list(next(it))))
                submitted += 1
            except StopIteration:
                it_done = True

        try:
            while submitted < window and not it_done:
                refill()
            while next_yield < submitted or not it_done:
                if next_yield in buf:
                    b = buf.pop(next_yield)
                    next_yield += 1
                    refill()
                    yield b
                    continue
                try:
                    ep, bidx, ok, payload = self._result_get(pool)
                except _WorkersDied as wd:
                    if next_yield == 0 and not buf and \
                            self._died_at_start(pool):
                        fall_back = True
                        break
                    raise wd from None
                if ep != epoch:   # a stale result of an abandoned epoch
                    continue
                if not ok:
                    exc, tb = payload
                    if exc is not None:
                        raise exc from RuntimeError(
                            f"DataLoader worker failed:\n{tb}")
                    raise RuntimeError(f"DataLoader worker failed:\n{tb}")
                buf[bidx] = pickle.loads(payload)
        finally:
            if persist:
                self._pool_active = False
            if not persist or fall_back:
                if pool is self._pool:
                    self._pool = None
                pool.shutdown()
        if fall_back:
            warnings.warn(
                "DataLoader worker processes died at start-up (the dataset "
                "may not survive unpickling in a fresh interpreter); "
                "falling back to a pool of threads.")
            self._mp_broken = True
            yield from self._iter_pool()

    @staticmethod
    def _died_at_start(pool):
        """Every worker died before any result, each with exit code 1: a
        Python exception at start-up (unpickling, init), the one case a
        pool of threads may retry in this process. A signal or another
        code means an item killed the worker, and retrying it here would
        kill the trainer."""
        deadline = time.time() + 2.0
        while len(pool.dead()) < len(pool.workers) and \
                time.time() < deadline:
            time.sleep(0.05)
        codes = [c for _, c in pool.dead()]
        return len(codes) == len(pool.workers) and all(c == 1 for c in codes)

    def _result_get(self, pool):
        deadline = time.time() + self.timeout if self.timeout else None
        while True:
            try:
                item = pool.result_q.get(timeout=1.0)
            except queue.Empty:
                dead = pool.dead()
                if dead:
                    # the dying worker's own traceback first
                    try:
                        while True:
                            it2 = pool.result_q.get_nowait()
                            if len(it2) == 3 and it2[0] == _CRASH:
                                pool.last_crash_tb = it2[2]
                    except queue.Empty:
                        pass
                    raise _WorkersDied(
                        dead, pool.last_crash_tb,
                        all_dead=len(dead) == len(pool.workers)) from None
                if deadline is not None and time.time() > deadline:
                    raise RuntimeError(
                        f"DataLoader timed out after {self.timeout}s "
                        "waiting for a worker batch") from None
                continue
            if len(item) == 3 and item[0] == _CRASH:
                pool.last_crash_tb = item[2]
                continue
            return item

    # -- the pool of threads --------------------------------------------

    def _iter_pool(self):
        """``num_workers`` threads, batches in the batch sampler's order
        with the same bounded window."""
        from concurrent.futures import ThreadPoolExecutor

        window = max(self.num_workers * self.prefetch_factor, 1)
        lock = threading.Lock()
        next_id = [0]

        def load(indices):
            if getattr(_worker_info, "info", None) is None:
                with lock:
                    my_id = next_id[0]
                    next_id[0] += 1
                _worker_info.info = _WorkerInfo(my_id, self.num_workers,
                                                self.dataset)
                if self.worker_init_fn is not None:
                    self.worker_init_fn(my_id)
            return self.collate_fn([self.dataset[i] for i in indices])

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = collections.deque()
            it = iter(self.batch_sampler)
            try:
                for _ in range(window):
                    futures.append(pool.submit(load, next(it)))
            except StopIteration:
                it = None
            while futures:
                yield futures.popleft().result()
                if it is not None:
                    try:
                        futures.append(pool.submit(load, next(it)))
                    except StopIteration:
                        it = None
