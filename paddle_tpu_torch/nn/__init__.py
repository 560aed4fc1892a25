"""``nn`` of the port: the functional forms and the RMSNorm layer.
``Linear`` and ``Embedding`` are ``torch.nn``'s own."""

from . import functional
from .layer import RMSNorm

__all__ = ["functional", "RMSNorm"]
