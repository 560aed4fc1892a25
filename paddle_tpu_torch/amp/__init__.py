"""``amp`` of the port: ``auto_cast``/``amp_guard``, ``decorate`` and the
``GradScaler`` (port of ``paddle_tpu/amp``; ``debugging`` is not ported
yet)."""

import torch

from .auto_cast import amp_guard, auto_cast, decorate, is_auto_cast_enabled
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate",
           "is_auto_cast_enabled", "is_float16_supported",
           "is_bfloat16_supported"]


def is_float16_supported(device=None):
    """fp16 compute on the card: True where the device (CUDA unless
    given) is a GPU."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def is_bfloat16_supported(device=None):
    return True
