"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, beside it.

The JAX package ``paddle_tpu`` is the reference; this package imports
neither it nor JAX. Its layout mirrors ``paddle_tpu`` (``ops``, ``nn``,
``models``, ``inference``). Every Pallas kernel on a ported path is a
kernel written by hand for Hopper under ``csrc/``, built with ``nvcc`` at
first use (``ops/kernels/_build.py``); each has its plain PyTorch version
beside it, which CPU tensors take.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit device they raise.

Importing the package imports nothing heavy: ``resolve_device``, ``save``,
``load``, ``seed``, ``get_rng_state``, ``set_rng_state`` and ``summary``
(and so torch) load at first use, so that the elastic launcher
(``python -m paddle_tpu_torch.distributed.launch``) runs without torch.
"""

import importlib

__all__ = ["resolve_device", "save", "load", "seed", "get_rng_state",
           "set_rng_state", "summary"]

_LAZY = {"resolve_device": ".device", "save": ".framework.io",
         "load": ".framework.io", "seed": ".framework.random",
         "get_rng_state": ".framework.random",
         "set_rng_state": ".framework.random", "summary": ".hapi.summary"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
