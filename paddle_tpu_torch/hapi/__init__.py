"""``hapi`` of the port: the high-level ``Model``."""

from .model import Model

__all__ = ["Model"]
