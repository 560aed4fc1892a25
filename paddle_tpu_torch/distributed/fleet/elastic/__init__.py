"""Elastic training: the port of ``paddle_tpu/distributed/fleet/elastic``.

Workers run a daemon heartbeat thread (``start_heartbeat``) into a
shared directory or a key-value store; the launcher (or any watcher)
polls an :class:`ElasticManager` for stale ranks and drives SIGTERM and
relaunch. Recovery is checkpoint-restart: ``latest_valid_checkpoint``
names the newest committed ``step_N``. The worker half of a preemption
is :class:`PreemptionGuard` and :class:`Preempted` (``preempt``).
Standard library only: the launcher imports this package and never
torch.
"""

from .manager import (ElasticManager, ElasticStatus, checkpoint_step,
                      latest_checkpoint, latest_valid_checkpoint,
                      start_heartbeat, stop_heartbeat)
from .preempt import PREEMPTED_EXIT_CODE, Preempted, PreemptionGuard

__all__ = ["ElasticManager", "ElasticStatus", "start_heartbeat",
           "stop_heartbeat", "latest_checkpoint", "checkpoint_step",
           "latest_valid_checkpoint", "PreemptionGuard", "Preempted",
           "PREEMPTED_EXIT_CODE"]
