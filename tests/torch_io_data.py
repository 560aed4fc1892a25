"""Picklable datasets for the port's loader tests (``test_torch_io.py``,
``test_torch_preempt_fit.py``). Worker processes import this module, so
it imports numpy and the port's ``io`` only: never jax."""

import os

import numpy as np

from paddle_tpu_torch import io


class ArrayDataset(io.Dataset):
    """Rows of equally long numpy arrays: item ``i`` is ``(a[i] for a)``."""

    def __init__(self, *arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)


class NestedDataset(io.Dataset):
    """Dicts of arrays, lists and numbers."""

    def __len__(self):
        return 10

    def __getitem__(self, idx):
        return {"x": np.full((3,), idx, np.float32),
                "pair": [np.int64(idx), float(idx) / 2],
                "name": f"s{idx}"}


class PidDataset(io.Dataset):
    """Records which process ran each item."""

    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return np.full((4,), idx, np.float32), np.int64(os.getpid())


class WorkerInfoDataset(io.Dataset):
    """Each item carries the id of the worker that loaded it and the id
    that worker_init_fn recorded."""

    def __init__(self, n=12):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        info = io.get_worker_info()
        return (np.int64(idx), np.int64(info.id), np.int64(info.num_workers),
                np.int64(os.environ.get("TORCH_IO_TEST_INIT", "-1")))


def init_worker(worker_id):
    os.environ["TORCH_IO_TEST_INIT"] = str(worker_id)


class FailingDataset(io.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, idx):
        if idx == 5:
            raise ValueError("boom at 5")
        return np.float32(idx)


class ExitingDataset(io.Dataset):
    """Item ``exit_idx`` kills its worker with ``os._exit(code)``."""

    def __init__(self, n=16, exit_idx=0, code=7):
        self.n = n
        self.exit_idx = exit_idx
        self.code = code

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        if idx == self.exit_idx:
            os._exit(self.code)
        return np.float32(idx)


class ChildPoisonDataset(io.Dataset):
    """Pickles in the parent, refuses to unpickle in a worker."""

    def __init__(self):
        self.n = 8

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return np.float32(idx)

    def __setstate__(self, state):
        raise RuntimeError("no unpickling in workers")


class Stream(io.IterableDataset):
    def __init__(self, n=20):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.asarray([i], dtype=np.float32)
