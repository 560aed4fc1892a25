"""``L1Decay`` and ``L2Decay``: a port of ``paddle_tpu/regularizer.py``.

Passed as an optimizer's ``weight_decay`` or set as a parameter's
``regularizer`` attribute (which takes precedence), each folds its decay
into the gradient before the update: ``grad + coeff * sign(param)`` and
``grad + coeff * param``, in the grad's dtype.
"""

from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    coeff: float = 0.0

    def __call__(self, param: torch.Tensor,
                 grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: grad += coeff * sign(param)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param).to(grad.dtype)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: grad += coeff * param."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * param.to(grad.dtype)

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"
