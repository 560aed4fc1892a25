"""Automatic mixed precision: a port of ``paddle_tpu/amp/auto_cast.py``.

This is not ``torch.autocast``. The JAX package casts only the operands
of its matmuls to the AMP dtype, inside the ops that take them: the
linear layers, ``matmul``, convolutions and attention's q, k and v; every
other op runs in the dtype it is given (softmax, norms and the loss see
whatever their inputs are). ``torch.autocast`` casts other ops too,
runs softmax and norms in f32, and never reaches the port's kernels. So
the port keeps the JAX package's thread-local state (:func:`auto_cast`)
and applies its rule (:func:`maybe_cast_matmul`) where the port's
matmuls are: ``nn.functional.linear`` (every ``nn.Linear`` of the
models, the tied lm_head) and ``nn.functional.
scaled_dot_product_attention``.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "is_auto_cast_enabled",
           "maybe_cast_matmul", "decorate"]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16


_state = _AmpState()


def _dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` / ``"float16"`` / ... or a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def is_auto_cast_enabled() -> bool:
    return _state.enabled


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Matmul operands in ``dtype`` inside the scope (thread-local). The
    custom lists, ``level`` and ``use_promote`` are accepted and change
    nothing, as in the JAX package, whose matmul casts read none of
    them."""
    prev = (_state.enabled, _state.dtype)
    _state.enabled = bool(enable)
    _state.dtype = _dtype(dtype)
    try:
        yield
    finally:
        _state.enabled, _state.dtype = prev


amp_guard = auto_cast


def maybe_cast_matmul(*tensors: torch.Tensor) -> tuple:
    """The operands in the AMP dtype while :func:`auto_cast` is on
    (float tensors only); as they are otherwise."""
    if not _state.enabled:
        return tensors
    lo = _state.dtype
    return tuple(t.to(lo) if t.is_floating_point() and t.dtype != lo else t
                 for t in tensors)


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """At O2, every float parameter of ``models`` becomes ``dtype`` in
    place: the ``Parameter`` objects stay (``.data`` is swapped), so an
    optimizer built before keeps them, and it keeps f32 master copies of
    them from its next step. Buffers stay as they are."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        lo = _dtype(dtype)
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(lo)
    if optimizers is None:
        return models
    return models, optimizers
