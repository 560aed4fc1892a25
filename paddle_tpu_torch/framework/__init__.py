"""``framework`` of the port: the runtime flags."""

from . import flags

__all__ = ["flags"]
