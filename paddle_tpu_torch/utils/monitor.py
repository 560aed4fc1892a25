"""Step-metrics hooks and a scalar log writer: a copy of the first part of
``paddle_tpu/utils/monitor.py`` (the operator statistics of
``amp.debugging`` are not ported yet).

A process-wide hook registry that training loops (``hapi.Model.fit``,
user code) emit into, and a dependency-free JSONL scalar writer a
dashboard can tail:

    from paddle_tpu_torch.utils import monitor

    writer = monitor.ScalarWriter("runs/exp1")       # metrics.jsonl
    remove = monitor.register_step_metrics_hook(writer)
    ...
    monitor.emit_step_metrics(step=i, loss=float(loss), lr=lr)
    remove(); writer.close()
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

__all__ = ["register_step_metrics_hook", "emit_step_metrics",
           "ScalarWriter", "global_step"]

_lock = threading.Lock()
_hooks: dict[int, Callable] = {}
_next_id = 0
_step = 0


def register_step_metrics_hook(fn: Callable) -> Callable[[], None]:
    """Register ``fn(metrics: dict)``; returns a remover callable."""
    global _next_id
    with _lock:
        hid = _next_id
        _next_id += 1
        _hooks[hid] = fn

    def remove():
        with _lock:
            _hooks.pop(hid, None)
    return remove


def global_step() -> int:
    """Steps emitted so far (auto-incremented when no explicit step)."""
    return _step


def emit_step_metrics(**metrics) -> None:
    """Fan metrics out to every registered hook. Cheap when no hooks are
    registered (the fast-path check is one dict-empty test)."""
    global _step
    if not _hooks:
        return
    if "step" not in metrics:
        with _lock:
            _step += 1
            metrics["step"] = _step
    else:
        _step = int(metrics["step"])
    metrics.setdefault("time", time.time())
    with _lock:
        hooks = list(_hooks.values())
    for fn in hooks:
        fn(metrics)


class ScalarWriter:
    """JSONL scalar sink (the LogWriter role, dependency-free): one line
    per emit, tail-able while training. Callable, so it can be passed
    straight to ``register_step_metrics_hook``."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a", buffering=1)

    def __call__(self, metrics: dict) -> None:
        self._f.write(json.dumps(
            {k: (float(v) if hasattr(v, "__float__") and
                 not isinstance(v, (str, bool)) else v)
             for k, v in metrics.items()}) + "\n")

    add_record = __call__

    def add_scalar(self, tag, value, step=None):
        rec = {"tag": tag, "value": float(value)}
        if step is not None:
            rec["step"] = int(step)
        self.__call__(rec)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
