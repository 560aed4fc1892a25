"""``framework`` of the port: the runtime flags and ``save``/``load``
(``io``)."""

from . import flags, io

__all__ = ["flags", "io"]
