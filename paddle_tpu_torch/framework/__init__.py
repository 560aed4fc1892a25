"""``framework`` of the port: the runtime flags, ``save``/``load``
(``io``) and the global RNG state (``random``)."""

from . import flags, io, random

__all__ = ["flags", "io", "random"]
