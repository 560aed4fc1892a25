"""``distributed`` of the port: so far the one-process checkpoints
(``checkpoint``)."""

from . import checkpoint

__all__ = ["checkpoint"]
