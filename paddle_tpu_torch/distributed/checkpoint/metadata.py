"""What the checkpoint files record about a tensor's dtype: the part of
``paddle_tpu/distributed/checkpoint/metadata.py`` that a one-process
save and load need.

A tensor is stored as an ``.npy`` file and its dtype by name in the
metadata (``"float32"``, ``"int32"``, ``"bfloat16"``, ...). numpy has
no bf16 or fp8 (the card's machine has no ``ml_dtypes``), so those are
stored as integer views of the same width and turned back with
``.view`` on load, never through f32: the files are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NONNATIVE_DTYPES", "dtype_name", "to_numpy", "from_numpy"]

#: dtype names numpy's npy format cannot round-trip natively
NONNATIVE_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's name where numpy has
    the type)."""
    return str(dtype).removeprefix("torch.")


def to_numpy(t: torch.Tensor):
    """``(array, dtype name)`` of a tensor, on the host: bf16 and fp8 as
    uint16/uint8 views."""
    t = t.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if name in NONNATIVE_DTYPES:
        t = t.view(torch.uint16 if t.element_size() == 2 else torch.uint8)
    return t.numpy(), name


def from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    """The inverse of :func:`to_numpy`: a CPU tensor of dtype ``name``."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if name in NONNATIVE_DTYPES:
        t = t.view(getattr(torch, name))
    return t
