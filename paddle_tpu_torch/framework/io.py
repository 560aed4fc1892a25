"""``save``/``load``: the ``.pdparams``/``.pdopt`` pickle of
``paddle_tpu/framework/io.py``, ported.

An object (a state dict, nested dicts and lists) is pickled with each
tensor replaced by a placeholder that holds its values as a numpy array,
its dtype's name, ``stop_gradient`` and ``name``. bf16 and fp8 have no
numpy type here, so they are stored as integer views of the same width
and viewed back on load (``distributed/checkpoint/metadata.py``).
``load`` puts the tensors on the device the caller names (``cuda``
unless given, as every entry point of the port).

``load`` also reads the files the JAX package's ``save`` writes, without
importing the JAX package, jax or ``ml_dtypes``: a restricted unpickler
maps the JAX placeholder (``paddle_tpu.framework.io._TensorPlaceholder``:
array, ``stop_gradient``, ``name``) to a reader of its three fields, and
rebuilds numpy's arrays itself from their raw bytes, so that an array of
an ``ml_dtypes`` type (bf16, fp8), which numpy pickles as
``numpy.dtype(ml_dtypes.bfloat16)``, becomes a tensor of that type
viewed from the same bytes. The JAX package's tensors keep its layout
(a Linear weight is [in, out]); ``hapi.Model.load`` converts them
(:func:`read`'s ``origin`` says whose file it is). Every other global a
file names is refused, so a file that is neither this program's nor the
JAX package's does not load. Unpickling still runs the constructors of
those classes: load only files this program or the JAX package wrote.
"""

from __future__ import annotations

import collections
import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.checkpoint.metadata import (NONNATIVE_DTYPES,
                                               from_numpy, to_numpy)

__all__ = ["save", "load", "read"]

_PROTOCOL = 4


class _TensorPlaceholder:
    def __init__(self, array, dtype: str, stop_gradient: bool, name: str):
        self.array = array
        self.dtype = dtype
        self.stop_gradient = stop_gradient
        self.name = name


class _JaxPlaceholder:
    """The JAX package's placeholder: ``array``, ``stop_gradient``,
    ``name`` (set by unpickling)."""


class _Foreign:
    """An ``ml_dtypes`` scalar type named by a JAX file."""

    def __init__(self, name):
        self.name = name


class _ForeignDtype:
    """``numpy.dtype`` of an ``ml_dtypes`` type: its torch dtype, and the
    unsigned integer type of its width that carries its bytes."""

    def __init__(self, name):
        self.torch_dtype = getattr(torch, name)
        self.carrier = np.uint16 if self.torch_dtype.itemsize == 2 \
            else np.uint8

    def __setstate__(self, state):
        pass    # byte order and sizes: little-endian, the type's own


class _Array:
    """An ndarray as numpy's ``_reconstruct`` + ``__setstate__`` rebuild
    it: ``value`` is a numpy array, or a CPU tensor viewed from the same
    bytes for an ml_dtypes type."""

    value = None

    def __setstate__(self, state):
        _version, shape, dtype, fortran, raw = state
        if not isinstance(raw, (bytes, bytearray)):
            raise pickle.UnpicklingError("load: object arrays are refused")
        foreign = isinstance(dtype, _ForeignDtype)
        # the array owns writable memory: immutable ``bytes`` are copied
        # once into a bytearray (a Fortran-order array is copied into C
        # order instead, which makes it writable too)
        if isinstance(raw, bytes) and not fortran:
            raw = bytearray(raw)
        arr = np.frombuffer(raw, dtype=dtype.carrier if foreign else dtype)
        arr = np.ascontiguousarray(
            arr.reshape(tuple(shape), order="F" if fortran else "C"))
        self.value = torch.from_numpy(arr).view(dtype.torch_dtype) \
            if foreign else arr


def _reconstruct(cls, shape, typecode):
    if cls is not np.ndarray:
        raise pickle.UnpicklingError(f"load: {cls!r} is refused")
    return _Array()


def _dtype(obj, align=False, copy=False):
    if isinstance(obj, _Foreign):
        return _ForeignDtype(obj.name)
    return np.dtype(obj, align, copy)


def _scalar(dtype, raw):
    return np.frombuffer(raw, dtype=dtype)[0]


_NUMPY_CORE = ("numpy._core.multiarray", "numpy.core.multiarray")
_ALLOWED = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): _dtype,
            ("collections", "OrderedDict"): collections.OrderedDict,
            ("paddle_tpu.framework.io", "_TensorPlaceholder"):
                _JaxPlaceholder,
            (__name__, "_TensorPlaceholder"): _TensorPlaceholder}
for _m in _NUMPY_CORE:
    _ALLOWED[(_m, "_reconstruct")] = _reconstruct
    _ALLOWED[(_m, "scalar")] = _scalar
for _n in NONNATIVE_DTYPES:
    _ALLOWED[("ml_dtypes", _n)] = _Foreign(_n)


class _Unpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self.origins = set()

    def find_class(self, module, name):
        found = _ALLOWED.get((module, name))
        if found is None:
            raise pickle.UnpicklingError(
                f"load: {module}.{name} is refused (a file of this program "
                "or of the JAX package names no such global)")
        if found is _JaxPlaceholder:
            self.origins.add("jax")
        elif found is _TensorPlaceholder:
            self.origins.add("port")
        return found


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


def _value(obj):
    return obj.value if isinstance(obj, _Array) else obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, (_TensorPlaceholder, _JaxPlaceholder)):
        arr = _value(obj.array)
        if isinstance(obj, _TensorPlaceholder):
            t, name = from_numpy(arr, obj.dtype), obj.dtype
        elif isinstance(arr, torch.Tensor):      # an ml_dtypes array
            t, name = arr, str(arr.dtype).removeprefix("torch.")
        else:
            t, name = torch.from_numpy(np.ascontiguousarray(arr)), None
        if return_numpy:
            # numpy has no bf16/fp8: those come back as f32 arrays
            return t.float().numpy() if name in NONNATIVE_DTYPES \
                else t.numpy()
        return t.to(device)
    if isinstance(obj, _Array):      # an array outside a placeholder
        return obj.value
    if isinstance(obj, dict):
        return type(obj)((k, _unpack(v, return_numpy, device))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=_PROTOCOL, **configs) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def read(path, return_numpy=False, device=None):
    """``(object, origin)``: :func:`load`'s object and whose file it is,
    ``"jax"`` (the JAX package's placeholders), ``"port"`` or None (no
    tensor in it). ``return_numpy=None`` gives numpy arrays for a JAX
    file (for ``convert``) and tensors on ``device`` for the port's."""
    with open(path, "rb") as f:
        up = _Unpickler(f)
        obj = up.load()
    if len(up.origins) > 1:
        raise pickle.UnpicklingError(f"load: {path} mixes the placeholders "
                                     "of two programs")
    origin = next(iter(up.origins), None)
    if return_numpy is None:
        return_numpy = origin == "jax"
    return (_unpack(obj, return_numpy,
                    None if return_numpy else resolve_device(device)),
            origin)


def load(path, return_numpy=False, device=None, **configs):
    """The object :func:`save` (or the JAX package's ``save``) wrote, its
    tensors on ``device`` (``cuda`` unless given; raises with no GPU and
    no device), or numpy arrays with ``return_numpy`` (bf16 and fp8 as
    f32)."""
    return read(path, return_numpy, device)[0]
