"""``nn`` of the port: the functional forms, the ``Linear``, ``RMSNorm``,
``LayerNorm`` and ``Dropout`` layers, the weight-only serving
quantization (``quant``) and the gradient clips (``ClipGradBy*``,
re-exported from ``optimizer.clip`` as ``paddle_tpu.nn`` re-exports
them). ``Embedding`` is ``torch.nn``'s own."""

from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                              ClipGradByValue)
from . import functional, quant
from .layer import Dropout, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "quant", "Linear", "RMSNorm", "LayerNorm",
           "Dropout", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue"]
