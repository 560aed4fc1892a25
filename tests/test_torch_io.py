"""The port's ``io`` against the JAX package's: datasets, samplers (index
streams equal index for index over several epochs, on the same seeds),
``random_split``, collate, and the ``DataLoader`` with 0 and 2 workers
(map-style and iterable) giving the JAX loader's batches; then the
workers' own contract (``worker_init_fn``/``get_worker_info``, error
types, an attributed death, persistent workers, the fallbacks to
threads) and the unchanged ``TensorDataset`` fast path. The loaders'
datasets live in ``torch_io_data.py`` (worker processes import it)."""

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio

from paddle_tpu_torch import io
from paddle_tpu_torch.io import _WorkersDied
from torch_io_data import (ArrayDataset, ChildPoisonDataset, ExitingDataset,
                           FailingDataset, NestedDataset, PidDataset, Stream,
                           WorkerInfoDataset, init_worker)

torch.set_num_threads(1)

X = np.random.RandomState(0).randn(22, 3).astype(np.float32)
Y = np.arange(22, dtype=np.int64)


def _epochs(sampler, n=3):
    return [list(sampler) for _ in range(n)]


# ---- samplers ---------------------------------------------------------------

SAMPLERS = {
    "sequence": lambda m, ds: m.SequenceSampler(ds),
    "random": lambda m, ds: m.RandomSampler(ds),
    "random_replacement": lambda m, ds: m.RandomSampler(
        ds, replacement=True, num_samples=9),
    "random_num_samples": lambda m, ds: m.RandomSampler(ds, num_samples=7),
    "subset_random": lambda m, ds: m.SubsetRandomSampler([3, 1, 4, 1, 5, 9]),
    "batch_shuffle": lambda m, ds: m.BatchSampler(ds, shuffle=True,
                                                  batch_size=4),
    "batch_drop_last": lambda m, ds: m.BatchSampler(ds, batch_size=5,
                                                    drop_last=True),
    "batch_of_sampler": lambda m, ds: m.BatchSampler(
        sampler=m.RandomSampler(ds), batch_size=3),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_streams_equal_jax(name):
    ds = ArrayDataset(X, Y)
    tp, jx = SAMPLERS[name](io, ds), SAMPLERS[name](jio, ds)
    assert len(tp) == len(jx)
    assert _epochs(tp, 4) == _epochs(jx, 4)


def test_weighted_sampler_stream_equals_jax():
    w = np.random.RandomState(3).rand(10)
    out = []
    for m in (io, jio):
        np.random.seed(7)     # both draw from numpy's global generator
        s = m.WeightedRandomSampler(w, 12)
        out.append(_epochs(s, 3))
        assert len(s) == 12
    assert out[0] == out[1]
    np.random.seed(7)
    without = list(io.WeightedRandomSampler(w, 10, replacement=False))
    assert sorted(without) == list(range(10))


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler_equals_jax_disjoint_covering(shuffle,
                                                               drop_last):
    ds = ArrayDataset(X, Y)
    n_ranks = 4
    for epoch in (0, 1, 5):
        seen = []
        for rank in range(n_ranks):
            tp = io.DistributedBatchSampler(ds, 3, num_replicas=n_ranks,
                                            rank=rank, shuffle=shuffle,
                                            drop_last=drop_last)
            jx = jio.DistributedBatchSampler(ds, 3, num_replicas=n_ranks,
                                             rank=rank, shuffle=shuffle,
                                             drop_last=drop_last)
            tp.set_epoch(epoch)
            jx.set_epoch(epoch)
            got = list(tp)
            assert got == list(jx) and len(tp) == len(jx)
            seen.append([i for b in got for i in b])
        if not drop_last:
            # each rank its own slice; together they cover the dataset
            # (22 rows over 4 ranks: 2 wrapped to pad to 24)
            assert sorted(set().union(*map(set, seen))) == list(range(22))
            assert sum(map(len, seen)) == 24
        if shuffle:
            order = [i for r in seen for i in r]
            assert order != sorted(order)


def test_distributed_batch_sampler_reads_the_launcher_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    s = io.DistributedBatchSampler(ArrayDataset(X, Y), 4)
    assert (s.nranks, s.local_rank) == (2, 1)
    assert [i for b in s for i in b] == list(range(1, 22, 2))


# ---- datasets -------------------------------------------------------------

def test_random_split_equals_jax():
    ds = ArrayDataset(X, Y)
    for lengths in ([10, 12], [0.5, 0.25, 0.25]):
        tp, jx = io.random_split(ds, lengths), jio.random_split(ds, lengths)
        assert [s.indices for s in tp] == [s.indices for s in jx]
        assert sorted(i for s in tp for i in s.indices) == list(range(22))
        assert all(isinstance(s, io.Subset) for s in tp)
    perm = np.random.RandomState(5).permutation(22)
    tp = io.random_split(ds, [11, 11], generator=perm)
    assert tp[0].indices == perm[:11].tolist()
    assert tp[1][0][1] == perm[11]


def test_datasets_equal_jax():
    a, b = ArrayDataset(X[:5], Y[:5]), ArrayDataset(X[5:12], Y[5:12])
    for tp, jx in ((io.ConcatDataset([a, b]), jio.ConcatDataset([a, b])),
                   (io.ComposeDataset([a, b]), jio.ComposeDataset([a, b])),
                   (io.Subset(b, [6, 0, 2]), jio.Subset(b, [6, 0, 2]))):
        assert len(tp) == len(jx)
        for i in range(len(tp)):
            for u, v in zip(tp[i], jx[i]):
                np.testing.assert_array_equal(u, v)
    chain = [c for c in io.ChainDataset([Stream(3), Stream(2)])]
    assert [int(c[0]) for c in chain] == [0, 1, 2, 0, 1]
    with pytest.raises(RuntimeError):
        len(Stream())
    t = io.TensorDataset([torch.zeros(3, 2), torch.ones(3)])
    assert isinstance(t, io.Dataset) and len(t) == 3
    with pytest.raises(ValueError, match="different lengths"):
        io.TensorDataset([torch.zeros(3), torch.zeros(4)])


# ---- collate --------------------------------------------------------------

def _leaves(obj):
    """(path, numpy value) of every leaf, for either package's output."""
    if isinstance(obj, dict):
        return [(f"{k}/{p}", v) for k in sorted(obj)
                for p, v in _leaves(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [(f"{i}/{p}", v) for i, o in enumerate(obj)
                for p, v in _leaves(o)]
    if isinstance(obj, torch.Tensor):
        return [("", obj.numpy())]
    if hasattr(obj, "numpy"):
        return [("", np.asarray(obj.numpy()))]
    return [("", obj)]


def _assert_same(tp, jx):
    a, b = _leaves(tp), _leaves(jx)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, u), (_, v) in zip(a, b):
        if isinstance(u, np.ndarray):
            assert isinstance(u, np.ndarray) and u.shape == np.shape(v), p
            np.testing.assert_array_equal(u, np.asarray(v), err_msg=p)
        else:
            assert u == v, p


def test_collate_nested_equals_jax():
    ds = NestedDataset()
    batch = [ds[i] for i in range(4)]
    tp, jx = io.default_collate_fn(batch), jio.default_collate_fn(batch)
    _assert_same(tp, jx)
    assert isinstance(tp["x"], torch.Tensor) and tp["x"].shape == (4, 3)
    assert tp["pair"][0].dtype == torch.int64
    assert tp["name"] == ["s0", "s1", "s2", "s3"]
    tensors = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(io.default_collate_fn(tensors),
                       torch.stack(tensors))


def test_convert_fn_equals_jax():
    sample = NestedDataset()[3]
    tp, jx = io.default_convert_fn(sample), jio.default_convert_fn(sample)
    _assert_same(tp, jx)
    assert isinstance(tp["x"], torch.Tensor) and tp["x"].shape == (3,)


# ---- the loader against the JAX loader --------------------------------------

def _batches(loader):
    return [_leaves(b) for b in loader]


@pytest.mark.parametrize("workers", [0, 2])
def test_map_style_loader_equals_jax(workers):
    ds = ArrayDataset(X, Y)
    kw = dict(batch_size=4, shuffle=True, drop_last=False)
    tp = io.DataLoader(ds, num_workers=workers, **kw)
    jx = jio.DataLoader(ds, num_workers=0, **kw)
    assert len(tp) == len(jx) == 6
    for _ in range(2):      # epoch 0 and 1 of each sampler
        a, b = _batches(tp), _batches(jx)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            for (_, p), (_, q) in zip(u, v):
                np.testing.assert_array_equal(p, q)


class _JStream(jio.IterableDataset):
    """The same stream as the JAX package's IterableDataset."""

    def __iter__(self):
        return iter(Stream())


@pytest.mark.parametrize("workers", [0, 2])
def test_iterable_loader_equals_jax(workers):
    tp = io.DataLoader(Stream(), batch_size=6, num_workers=workers)
    jx = jio.DataLoader(_JStream(), batch_size=6, num_workers=0)
    a = [b.numpy() for b in tp]
    b = [np.asarray(x.numpy()) for x in jx]
    assert [x.shape for x in a] == [(6, 1), (6, 1), (6, 1), (2, 1)]
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    with pytest.raises(TypeError):
        len(tp)


def test_nested_collate_through_workers_equals_jax():
    tp = io.DataLoader(NestedDataset(), batch_size=3, num_workers=2)
    jx = jio.DataLoader(NestedDataset(), batch_size=3, num_workers=0)
    for u, v in zip(tp, jx):
        _assert_same(u, v)


def test_unbatched_and_batch_sampler_loaders():
    ds = ArrayDataset(X, Y)
    one = list(io.DataLoader(ds, batch_size=None))
    assert len(one) == 22 and one[3][1].shape == ()
    assert int(one[3][1]) == 3
    bs = io.BatchSampler(ds, batch_size=5, drop_last=True)
    got = list(io.DataLoader(ds, batch_sampler=bs, num_workers=2))
    assert [b[1].tolist() for b in got] == [list(range(i, i + 5))
                                            for i in range(0, 20, 5)]
    seen = []
    lists = io.DataLoader(ds, batch_size=8,
                          collate_fn=lambda b: seen.append(len(b)) or b)
    assert [len(b) for b in lists] == [8, 8, 6] and seen == [8, 8, 6]


# ---- the workers' contract --------------------------------------------------

def test_workers_run_in_other_processes_in_order():
    import os
    pids, vals = set(), []
    for x, pid in io.DataLoader(PidDataset(32), batch_size=4,
                                num_workers=2):
        pids.update(pid.tolist())
        vals.extend(x[:, 0].int().tolist())
    assert os.getpid() not in pids
    assert vals == list(range(32))


def test_worker_init_fn_and_worker_info():
    got = list(io.DataLoader(WorkerInfoDataset(12), batch_size=2,
                             num_workers=3, worker_init_fn=init_worker))
    idx, wid, nw, init = (torch.cat([b[k] for b in got]) for k in range(4))
    assert idx.tolist() == list(range(12))
    assert set(nw.tolist()) == {3}
    assert set(wid.tolist()) <= {0, 1, 2}
    assert torch.equal(wid, init)      # init ran in the same worker
    assert io.get_worker_info() is None


def test_worker_exception_keeps_its_type():
    with pytest.raises(ValueError, match="boom at 5"):
        list(io.DataLoader(FailingDataset(), batch_size=2, num_workers=2))


def test_worker_death_is_attributed_with_its_code():
    loader = io.DataLoader(ExitingDataset(16, exit_idx=9, code=7),
                           batch_size=2, num_workers=2)
    with pytest.raises(_WorkersDied) as ei:
        list(loader)
    assert ei.value.exitcode == 7
    assert ei.value.worker_id in (0, 1)
    assert "exit code 7" in str(ei.value)
    assert not loader._mp_broken      # an item killed it: no fallback


def test_persistent_workers_are_reused():
    loader = io.DataLoader(PidDataset(16), batch_size=4, num_workers=2,
                           persistent_workers=True)
    try:
        pids1 = {int(p) for _, pid in loader for p in pid}
        pool = loader._pool
        own = {w.pid for w in pool.workers}
        pids2 = {int(p) for _, pid in loader for p in pid}
        assert pool is not None and loader._pool is pool
        # both epochs ran in the pool's own workers, whichever worker took
        # which batch
        assert pids1 <= own and pids2 <= own
        assert {w.pid for w in loader._pool.workers} == own
        both = list(zip(loader, loader))   # a second live iterator
        assert [int(a[0][0, 0]) for a, _ in both] == [0, 4, 8, 12]
        assert [int(b[0][0, 0]) for _, b in both] == [0, 4, 8, 12]
    finally:
        del loader


class _LocalDataset(io.Dataset):
    blocker = None

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        return np.float32(idx)


def test_unpicklable_dataset_falls_back_to_threads():
    ds = _LocalDataset()
    ds.blocker = lambda: None            # a lambda does not pickle
    ids = []
    with pytest.warns(UserWarning, match="picklable"):
        out = list(io.DataLoader(ds, batch_size=3, num_workers=2,
                                 worker_init_fn=ids.append))
    assert torch.cat(out).tolist() == list(range(8))
    assert sorted(ids) == sorted(set(ids)) and set(ids) <= {0, 1}


def test_child_unpickle_failure_falls_back():
    loader = io.DataLoader(ChildPoisonDataset(), batch_size=4,
                           num_workers=2)
    with pytest.warns(UserWarning, match="threads"):
        out = [b.numpy() for b in loader]
    assert np.concatenate(out).tolist() == list(range(8))
    assert loader._mp_broken


# ---- the TensorDataset fast path ------------------------------------------

@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_tensor_dataset_fast_path_unchanged(shuffle, drop_last):
    """One index_select per tensor over the epoch-seeded permutation
    (torch.randperm from a generator seeded with the epoch number); the
    workers are not used there."""
    a = torch.arange(22 * 3, dtype=torch.float32).reshape(22, 3)
    b = torch.arange(22)
    ds = io.TensorDataset([a, b])
    loader = io.DataLoader(ds, batch_size=4, shuffle=shuffle,
                           drop_last=drop_last, num_workers=2)
    assert len(loader) == (5 if drop_last else 6)
    for epoch in range(2):
        order = torch.randperm(22, generator=torch.Generator().manual_seed(
            epoch)) if shuffle else torch.arange(22)
        got = list(loader)
        assert len(got) == len(loader)
        for i, (u, v) in enumerate(got):
            idx = order[4 * i:4 * i + 4]
            assert torch.equal(u, a[idx]) and torch.equal(v, b[idx])
    loader._seed_epochs_from(1)
    first = next(iter(loader))[1]
    assert torch.equal(first, (torch.randperm(22, generator=torch.Generator(
    ).manual_seed(1)) if shuffle else torch.arange(22))[:4])
    g = torch.Generator().manual_seed(9)
    fixed = io.DataLoader(ds, batch_size=22, shuffle=True, generator=g)
    assert torch.equal(next(iter(fixed))[1], torch.randperm(
        22, generator=torch.Generator().manual_seed(9)))


def test_fit_loader_order_is_seeded_by_the_epoch():
    """``_seed_epochs_from(e)`` makes the general path's next epoch draw
    the order of a sampler's epoch ``e`` (what a resumed fit needs)."""
    ds = ArrayDataset(X, Y)
    whole = io.DataLoader(ds, batch_size=4, shuffle=True)
    epochs = [[b[1].tolist() for b in whole] for _ in range(3)]
    resumed = io.DataLoader(ds, batch_size=4, shuffle=True)
    resumed._seed_epochs_from(2)
    assert [b[1].tolist() for b in resumed] == epochs[2]
