"""``save``/``load``: the ``.pdparams``/``.pdopt`` pickle of
``paddle_tpu/framework/io.py``, ported.

An object (a state dict, nested dicts and lists) is pickled with each
tensor replaced by a placeholder that holds its values as a numpy array,
its dtype's name, ``stop_gradient`` and ``name``. bf16 and fp8 have no
numpy type here, so they are stored as integer views of the same width
and viewed back on load (``distributed/checkpoint/metadata.py``).
``load`` puts the tensors on the device the caller names (``cuda``
unless given, as every entry point of the port). The placeholder is this package's class, so a file the JAX
package wrote does not unpickle here, nor the reverse; the checkpoint
directories of ``distributed.checkpoint`` are the format both read.
Unpickling runs code: load only files this program wrote.
"""

from __future__ import annotations

import os
import pickle

import torch

from ..device import resolve_device
from ..distributed.checkpoint.metadata import (NONNATIVE_DTYPES,
                                               from_numpy, to_numpy)

__all__ = ["save", "load"]

_PROTOCOL = 4


class _TensorPlaceholder:
    def __init__(self, array, dtype: str, stop_gradient: bool, name: str):
        self.array = array
        self.dtype = dtype
        self.stop_gradient = stop_gradient
        self.name = name


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        arr, dtype = to_numpy(obj)
        return _TensorPlaceholder(arr, dtype, not obj.requires_grad,
                                  getattr(obj, "name", "") or "")
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPlaceholder):
        t = from_numpy(obj.array, obj.dtype)
        if return_numpy:
            # numpy has no bf16/fp8: those come back as f32 arrays
            return t.float().numpy() if obj.dtype in NONNATIVE_DTYPES \
                else obj.array
        return t.to(device)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=_PROTOCOL, **configs) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, device=None, **configs):
    """The object :func:`save` wrote, its tensors on ``device`` (``cuda``
    unless given; raises with no GPU and no device), or numpy arrays
    with ``return_numpy``."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy,
                   None if return_numpy else resolve_device(device))
