"""Functional forms on the serving path.

Ports of ``paddle_tpu/nn/functional/norm.py::rms_norm`` and
``paddle_tpu/nn/functional/activation.py::swiglu``. Where the JAX package
chose the Pallas kernel by backend and flags, the port's kernel wrappers
choose by the device of the tensor: CUDA launches the kernel, the CPU
takes the plain version.
"""

from __future__ import annotations

import torch

from ..ops.kernels import rms_norm as _rms
from ..ops.kernels import swiglu as _sw

__all__ = ["rms_norm", "swiglu"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)).to(x.dtype) * weight``."""
    return _rms.rms_norm(x, weight, epsilon)


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y``."""
    return _sw.swiglu(x, y)
