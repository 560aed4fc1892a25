"""Step-metrics hooks, a scalar log writer and operator statistics: a
port of ``paddle_tpu/utils/monitor.py``.

A process-wide hook registry that training loops (``hapi.Model.fit``,
user code) emit into, and a dependency-free JSONL scalar writer a
dashboard can tail:

    from paddle_tpu_torch.utils import monitor

    writer = monitor.ScalarWriter("runs/exp1")       # metrics.jsonl
    remove = monitor.register_step_metrics_hook(writer)
    ...
    monitor.emit_step_metrics(step=i, loss=float(loss), lr=lr)
    remove(); writer.close()

The operator statistics (``enable_op_stats``, ``op_stats_summary``; the
``amp.debugging`` operator stats) count the ops a block runs by ``(name,
dtype)`` through a ``TorchDispatchMode``, so the names are aten's
(``aten.mm.default``), where the JAX package counts its own ``apply``
names; the dtype is that of the op's first tensor input. They count in
the thread that enabled them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

__all__ = ["register_step_metrics_hook", "emit_step_metrics",
           "ScalarWriter", "global_step", "enable_op_stats",
           "disable_op_stats", "op_stats_summary", "op_stats"]

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


# ---- operator-call statistics (the amp.debugging operator stats) ----------

op_stats: dict = {}
_op_mode = None


def _dtype_name(args, kwargs):
    import torch
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return str(a.dtype).replace("torch.", "")
        if isinstance(a, (list, tuple)):
            for t in a:
                if isinstance(t, torch.Tensor):
                    return str(t.dtype).replace("torch.", "")
    return "none"


def _record_op(name: str, dtype: str) -> None:
    key = (name or "op", dtype)
    op_stats[key] = op_stats.get(key, 0) + 1


def enable_op_stats() -> None:
    """Count every op dispatched from here on by ``(aten name, dtype of
    the first tensor input)`` until :func:`disable_op_stats`."""
    global _op_mode
    if _op_mode is not None:
        return
    from torch.utils._python_dispatch import TorchDispatchMode

    class _OpStats(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            _record_op(str(func), _dtype_name(args, kwargs))
            return func(*args, **kwargs)

    _op_mode = _OpStats()
    _op_mode.__enter__()


def disable_op_stats() -> None:
    global _op_mode
    if _op_mode is not None:
        mode, _op_mode = _op_mode, None
        mode.__exit__(None, None, None)


def op_stats_summary(reset=True) -> dict:
    """``{"name[dtype]": count}`` in sorted order (the JAX summary's key
    format); clears the counts unless ``reset`` is False."""
    out = {f"{n}[{d}]": c for (n, d), c in sorted(op_stats.items())}
    if reset:
        op_stats.clear()
    return out
