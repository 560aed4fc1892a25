"""``distributed.fleet`` of the port: so far ``elastic`` (preemption and
the heartbeat manager). Standard library only."""

from . import elastic

__all__ = ["elastic"]
