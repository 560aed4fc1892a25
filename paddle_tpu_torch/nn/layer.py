"""Layers of the port: ``RMSNorm`` (port of ``paddle_tpu/nn/layer/norm.py::
RMSNorm``) and ``Linear``, ``torch.nn.Linear`` whose forward is
:func:`.functional.linear` (its matmul operands cast under
``amp.auto_cast``, as the JAX package's ``nn.Linear``). The weight keeps
torch's [out, in] layout."""

from __future__ import annotations

import torch
from torch import nn

from ..amp.auto_cast import _state as _amp_state
from ..device import resolve_device
from . import functional as F

__all__ = ["Linear", "RMSNorm"]


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned scale (initialised to ones).
    Built on ``device`` (``cuda`` unless given; raises with no GPU and no
    device)."""

    def __init__(self, normalized_shape, epsilon=1e-6, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            self.normalized_shape, device=resolve_device(device),
            dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.epsilon)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # AMP off (serving, f32 or bf16 training) costs one thread-local
        # read over torch.nn.Linear: no frame of its own
        if _amp_state.enabled:
            return F.linear(x, self.weight, self.bias)
        return nn.functional.linear(x, self.weight, self.bias)
