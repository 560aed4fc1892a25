"""``incubate.nn`` of the port: the functional serving attention."""

from . import functional

__all__ = ["functional"]
