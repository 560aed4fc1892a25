"""``hapi`` of the port: the high-level ``Model`` and its callbacks."""

from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
