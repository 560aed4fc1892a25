"""``utils`` of the port: ``monitor`` (step-metrics hooks) and ``retry``
(bounded backoff for the checkpoint I/O)."""

from . import monitor, retry

__all__ = ["monitor", "retry"]
