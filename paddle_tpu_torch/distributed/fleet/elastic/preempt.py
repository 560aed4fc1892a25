"""Preemption, the worker half of elastic training: the port of
``paddle_tpu/distributed/fleet/elastic/preempt.py``.

A scheduler preempts a worker with SIGTERM and gives it a grace window
before SIGKILL. The contract:

- :class:`PreemptionGuard` turns the signal into a flag that a training
  loop polls at step boundaries. The handler only records the time and
  counts (async-signal-safe); the loop drains at its next boundary.
  Under a process group of more than one rank the loop polls
  :meth:`PreemptionGuard.requested_anywhere`: the flag all-reduced (MAX)
  over the world, one small collective a step boundary, so a signal that
  reaches the ranks at different step boundaries stops every rank after
  the same step (a rank that stopped alone would leave the others in the
  next step's collectives).
- The loop commits a bounded-time **emergency checkpoint** and raises
  :class:`Preempted`.
- The trainer exits :data:`PREEMPTED_EXIT_CODE` (``os.EX_TEMPFAIL`` =
  75, "temporary failure, retry"), which the elastic launcher books as
  a clean preemption, relaunched on its own budget, not as a crash.

A third SIGTERM while draining exits at once (``os._exit``). Standard
library only at import: ``torch`` is imported by the agreement alone,
once a process group exists.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

__all__ = ["PreemptionGuard", "Preempted", "PREEMPTED_EXIT_CODE"]

#: worker exit code of a clean preemption (emergency checkpoint
#: committed, state resumable): os.EX_TEMPFAIL
PREEMPTED_EXIT_CODE = getattr(os, "EX_TEMPFAIL", 75)

#: the grace window between SIGTERM and SIGKILL, from the environment
_GRACE_ENV = "PADDLE_PREEMPT_GRACE_S"
_DEFAULT_GRACE_S = 30.0

#: the third signal while draining forces an immediate exit
_FORCE_AFTER = 3


class Preempted(RuntimeError):
    """Raised by a preemption-aware loop after its emergency checkpoint
    committed; carries the checkpoint, the epoch and the epoch-relative
    step. Left uncaught, it exits the process with ``exit_code``."""

    def __init__(self, message, checkpoint=None, epoch=None, step=None):
        super().__init__(message)
        self.checkpoint = checkpoint
        self.epoch = epoch
        self.step = step
        self.exit_code = PREEMPTED_EXIT_CODE


def _install_excepthook():
    """Chain, once per process, a ``sys.excepthook`` under which an
    uncaught :class:`Preempted` dumps a flight-recorder bundle (when a
    recorder is installed) and exits ``PREEMPTED_EXIT_CODE`` rather than
    the 1 a launcher books as a crash."""
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        if isinstance(exc, Preempted):
            try:
                from ....profiler import flight_recorder as _frec
                rec = _frec.get_recorder()
                if rec is not None:
                    rec.dump(f"preempted: {exc}")
            except Exception:  # noqa: BLE001 — the exit must proceed
                pass
            print(f"paddle_tpu_torch: {exc} — exiting {exc.exit_code} "
                  f"(clean preemption)", file=sys.stderr)
            sys.exit(exc.exit_code)
        prev(exc_type, exc, tb)

    hook._paddle_preempt = True
    if not getattr(prev, "_paddle_preempt", False):
        sys.excepthook = hook


class PreemptionGuard:
    """SIGTERM as a pollable flag with a grace-window deadline.

    ``install()`` claims the signal handlers (on the main thread only;
    elsewhere the guard stays inert and :meth:`request` still drives
    it) and chains the ``Preempted`` excepthook. ``uninstall()``
    restores the previous handlers. Also a context manager."""

    def __init__(self, signals=(signal.SIGTERM,), grace_s=None):
        self.signals = tuple(signals)
        if grace_s is None:
            grace_s = float(os.environ.get(_GRACE_ENV, _DEFAULT_GRACE_S))
        self.grace_s = float(grace_s)
        self._requested_at = None
        self._count = 0
        self._prev = {}
        self._installed = False
        self._lock = threading.Lock()

    def _on_signal(self, signum, frame):
        self._count += 1
        if self._requested_at is None:
            self._requested_at = time.time()
        if self._count >= _FORCE_AFTER:
            os._exit(128 + int(signum))

    def request(self, grace_s=None):
        """Mark a preemption without a signal: the hook for tests and
        for schedulers that give notice in-band."""
        if grace_s is not None:
            self.grace_s = float(grace_s)
        if self._requested_at is None:
            self._requested_at = time.time()
        self._count += 1
        return self

    def requested(self) -> bool:
        """Has a preemption been signalled to this process?"""
        return self._requested_at is not None

    def requested_anywhere(self) -> bool:
        """Polled at step boundaries: has a preemption been signalled to
        any rank? :meth:`requested` without a process group of more than
        one rank; with one, this rank's flag all-reduced (MAX) over the
        world (every rank must poll at the same step boundary). A rank
        that learns of it this way marks itself requested (its grace
        window starts now)."""
        mine = self.requested()
        dist = sys.modules.get("torch.distributed")
        if dist is None or not dist.is_available() or \
                not dist.is_initialized() or dist.get_world_size() <= 1:
            return mine
        import torch

        from ...communication import ReduceOp, all_reduce
        from ...env import current_device
        flag = torch.tensor([1.0 if mine else 0.0],
                            device=current_device() or "cpu")
        all_reduce(flag, ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed and self._requested_at is None:
            self._requested_at = time.time()
        return agreed

    def remaining(self) -> float:
        """Seconds left of the grace window: ``inf`` before a signal, at
        least 1 after (the emergency save always gets a bound)."""
        if self._requested_at is None:
            return float("inf")
        return max(1.0, self._requested_at + self.grace_s - time.time())

    def reset(self):
        self._requested_at = None
        self._count = 0
        return self

    def install(self):
        with self._lock:
            if self._installed:
                return self
            try:
                for sig in self.signals:
                    self._prev[sig] = signal.signal(sig, self._on_signal)
                self._installed = True
            except ValueError:
                # not the main thread: the guard works through request()
                self._prev.clear()
            _install_excepthook()
        return self

    def uninstall(self):
        with self._lock:
            if not self._installed:
                return
            for sig, prev in self._prev.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, TypeError):
                    pass
            self._prev.clear()
            self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
