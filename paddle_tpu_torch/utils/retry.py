"""Bounded exponential-backoff retry for I/O paths: the port's own copy of
``paddle_tpu/utils/retry.py``, which the checkpoint I/O uses.

Checkpoint writes hit one failure class: transient filesystem errors
(EIO on a flaky NFS mount, ENOSPC that a retention GC or operator frees,
EAGAIN / EBUSY under contention). ``retry_call`` retries exactly that
class — a bounded number of attempts with exponential backoff capped at
``max_delay`` — and re-raises the last exception unchanged, so callers
keep their original error semantics when the fault is real.

Non-transient errors (ENOENT, EACCES, ENOTDIR, ValueError, ...) are
never retried: retrying a checkpoint write to a path that does not
exist only delays the real diagnostic.
"""

from __future__ import annotations

import errno
import functools
import random
import time

__all__ = ["retry_call", "retryable", "is_transient_oserror",
           "TRANSIENT_OS_ERRNOS"]

#: errnos worth retrying: contention / flaky-media faults that a
#: short wait can clear. ENOSPC is included deliberately — on the
#: checkpoint path a concurrent retention GC (or an operator) frees
#: space, and the alternative is losing the step's state entirely.
TRANSIENT_OS_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ENOSPC,
    errno.ESTALE, errno.ETIMEDOUT, errno.ECONNRESET,
})


def is_transient_oserror(exc):
    """True for OSErrors whose errno is plausibly transient."""
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_OS_ERRNOS


def _default_should_retry(exc):
    return isinstance(exc, TimeoutError) or is_transient_oserror(exc)


def retry_call(fn, *args, retries=3, base_delay=0.05, max_delay=1.0,
               jitter=0.25, should_retry=None, on_retry=None,
               sleep=time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``; on a transient failure retry up to
    ``retries`` more times with bounded exponential backoff
    (``base_delay * 2**attempt`` capped at ``max_delay``, plus up to
    ``jitter`` fraction of random spread so herds of ranks don't
    retry in lockstep). Re-raises the last exception when attempts are
    exhausted or the failure is not retryable.

    ``should_retry(exc) -> bool`` overrides the default policy
    (transient OSErrors + TimeoutError). ``on_retry(exc, attempt,
    delay)`` observes each retry (logging/metrics hooks).
    """
    should_retry = should_retry or _default_should_retry
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — policy decides, below
            if attempt >= retries or not should_retry(e):
                raise
            delay = min(max_delay, base_delay * (2 ** attempt))
            if jitter:
                delay *= 1.0 + jitter * random.random()
            if on_retry is not None:
                on_retry(e, attempt, delay)
            sleep(delay)
            attempt += 1


def retryable(**cfg):
    """Decorator form of :func:`retry_call`; ``cfg`` is its keyword
    configuration (``retries=``, ``base_delay=``, ...)."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return retry_call(fn, *args, **cfg, **kwargs)
        return inner
    return deco
