"""Layers of the port. Port of ``paddle_tpu/nn/layer/norm.py::RMSNorm``."""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F

__all__ = ["RMSNorm"]


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
