"""``incubate`` of the port: activation recompute and the functional
paged decode attention (``incubate.nn.functional``)."""

from . import nn
from .recompute import recompute

__all__ = ["nn", "recompute"]
