"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, beside it.

The JAX package ``paddle_tpu`` is the reference; this package imports
neither it nor JAX. Its layout mirrors ``paddle_tpu`` (``ops``, ``nn``,
``models``, ``inference``). Every Pallas kernel on a ported path is a
kernel written by hand for Hopper under ``csrc/``, built with ``nvcc`` at
first use (``ops/kernels/_build.py``); each has its plain PyTorch version
beside it, which CPU tensors take.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit device they raise.
"""

from .device import resolve_device
from .framework.io import load, save

__all__ = ["resolve_device", "save", "load"]
