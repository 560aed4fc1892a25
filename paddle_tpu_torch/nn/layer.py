"""Layers of the port: ``RMSNorm`` and ``LayerNorm`` (ports of
``paddle_tpu/nn/layer/norm.py``), ``Dropout`` (of ``common.py``) and
``Linear``, ``torch.nn.Linear`` whose forward is
:func:`.functional.linear` (its matmul operands cast under
``amp.auto_cast``, as the JAX package's ``nn.Linear``). The weight keeps
torch's [out, in] layout."""

from __future__ import annotations

import torch
from torch import nn

from ..amp.auto_cast import _state as _amp_state
from ..device import resolve_device
from . import functional as F

__all__ = ["Linear", "RMSNorm", "LayerNorm", "Dropout"]


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


class LayerNorm(nn.Module):
    """:func:`.functional.layer_norm` with a learned ``weight`` (ones) and
    ``bias`` (zeros), the JAX package's attribute names and rounding.
    Built on ``device`` (``cuda`` unless given; raises with no GPU and no
    device)."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class Dropout(nn.Module):
    """:func:`.functional.dropout` while training, drawing from
    ``generator`` (a ``torch.Generator`` on the input's device; a model
    gives all its dropouts one); the identity in eval mode."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, self.training, self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # AMP off (serving, f32 or bf16 training) costs one thread-local
        # read over torch.nn.Linear: no frame of its own
        if _amp_state.enabled:
            return F.linear(x, self.weight, self.bias)
        return nn.functional.linear(x, self.weight, self.bias)
