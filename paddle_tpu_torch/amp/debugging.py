"""``amp.debugging``: operator statistics, numerics checks and the
comparison of two dumps. Port of the ``debugging`` namespace of
``paddle_tpu/amp/__init__.py``.

- ``enable/disable_operator_stats_collection`` and
  ``collect_operator_stats`` count ops by ``(name, dtype)``
  (``utils.monitor``: aten's names).
- ``check_numerics`` counts the non-finite elements on the device and
  reads that count once, raising the JAX package's message.
- ``enable/disable_check_nan_inf``: where the JAX package sets
  ``jax_debug_nans``, a ``TorchDispatchMode`` checks every floating
  output of every op and raises ``FloatingPointError`` naming the aten op
  that produced a NaN or an inf (one host read an op: a debugging tool).
- ``DebugMode``, ``check_layer_numerics`` and ``compare_accuracy`` (the
  same report from the same JSONL dumps).
"""

from __future__ import annotations

import contextlib
import json
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils import monitor

__all__ = ["enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "check_numerics", "enable_check_nan_inf", "disable_check_nan_inf",
           "DebugMode", "check_layer_numerics", "compare_accuracy"]


def enable_operator_stats_collection():
    monitor.enable_op_stats()


def disable_operator_stats_collection():
    monitor.disable_op_stats()


@contextlib.contextmanager
def collect_operator_stats():
    """Count ops by (name, dtype) within the block and print the summary
    on exit."""
    monitor.enable_op_stats()
    try:
        yield
    finally:
        monitor.disable_op_stats()
        summary = monitor.op_stats_summary()
        print("operator stats:")
        for k, v in summary.items():
            print(f"  {k}: {v}")


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """``tensor``, or ``RuntimeError`` if any element is NaN or inf. The
    count is one reduction on the tensor's device and one host read."""
    bad = int(torch.count_nonzero(~torch.isfinite(tensor)))
    if bad:
        raise RuntimeError(
            f"check_numerics: {bad} non-finite element(s) in "
            f"{op_type or 'tensor'} {var_name}")
    return tensor


def _outputs(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _outputs(o)


class _CheckNanInf(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _outputs(out):
            if t.is_floating_point() and t.numel() \
                    and not bool(torch.isfinite(t).all()):
                kind = "nan" if bool(torch.isnan(t).any()) else "inf"
                raise FloatingPointError(
                    f"check_nan_inf: invalid value ({kind}) encountered in "
                    f"{func}")
        return out


_nan_inf_mode = None


def enable_check_nan_inf():
    """Check every floating op output from here on (this thread)."""
    global _nan_inf_mode
    if _nan_inf_mode is None:
        _nan_inf_mode = _CheckNanInf()
        _nan_inf_mode.__enter__()


def disable_check_nan_inf():
    global _nan_inf_mode
    if _nan_inf_mode is not None:
        mode, _nan_inf_mode = _nan_inf_mode, None
        mode.__exit__(None, None, None)


class DebugMode:
    """``amp.debugging.DebugMode`` (the TensorChecker granularity knobs;
    the checks here are CHECK_ALL)."""
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3
    CHECK_ALL_AND_ABORT = 4
    DUMP_ALL = 5


def check_layer_numerics(layer):
    """Make every forward output of ``layer`` numerics-checked."""
    orig = layer.forward

    def wrapped(*a, **k):
        out = orig(*a, **k)
        for t in _outputs(out):
            check_numerics(t, op_type=type(layer).__name__)
        return out
    layer.forward = wrapped
    return layer


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1.0, dump_all_module=False):
    """Diff two op-stats JSONL dumps (one record a line, keyed by
    ``"op"``) and write the records that differ as a JSON report."""
    def load(path):
        rows = {}
        with open(path) as fh:
            for line in fh:
                if line.strip():
                    rec = json.loads(line)
                    rows[rec.get("op", repr(rec))] = rec
        return rows

    a, b = load(dump_path), load(another_dump_path)
    report = []
    for op in sorted(set(a) | set(b)):
        ra, rb = a.get(op), b.get(op)
        if ra != rb:
            report.append({"op": op, "run1": ra, "run2": rb})
    os.makedirs(os.path.dirname(output_filename) or ".", exist_ok=True)
    with open(output_filename, "w") as fh:
        json.dump(report, fh, indent=1)
    return report
