"""``nn`` of the port: the functional forms, the RMSNorm layer and the
weight-only serving quantization (``quant``). ``Linear`` and
``Embedding`` are ``torch.nn``'s own."""

from . import functional, quant
from .layer import RMSNorm

__all__ = ["functional", "quant", "RMSNorm"]
