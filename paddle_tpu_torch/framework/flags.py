"""Runtime flags: the subset of ``paddle_tpu/framework/flags.py`` that the
port's training path reads, in a copy of its own.

Every flag records where its value came from: ``"default"`` (the
``define_flag`` literal), ``"env"`` (a ``FLAGS_*`` environment variable
when the flag was defined) or ``"set"`` (a :func:`set_flags` call).
Anything but ``"default"`` is an explicit choice, and an explicit choice
wins over a :class:`scoped_default`.
"""

from __future__ import annotations

import os
import threading
from typing import Any

__all__ = ["define_flag", "flag", "flag_source", "get_flags", "set_flags",
           "scoped_default"]

_lock = threading.Lock()
_registry: dict[str, dict] = {}


def _key(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def _parse_env(value: str, typ):
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def define_flag(name: str, default: Any, help: str = "") -> None:
    """Define ``FLAGS_<name>``; an environment variable of that name, if
    it parses, gives the initial value."""
    name = _key(name)
    typ = type(default)
    value, source = default, "default"
    env = os.environ.get(name)
    if env is not None:
        try:
            value, source = _parse_env(env, typ), "env"
        except (TypeError, ValueError):
            pass
    with _lock:
        _registry[name] = {"value": value, "default": default, "help": help,
                           "type": typ, "source": source}


def flag(name: str) -> Any:
    return _registry[_key(name)]["value"]


def flag_source(name: str) -> str:
    """``"default"``, ``"env"`` or ``"set"``."""
    return _registry[_key(name)]["source"]


def get_flags(names=None) -> dict[str, Any]:
    if names is None:
        return {k: v["value"] for k, v in _registry.items()}
    if isinstance(names, str):
        names = [names]
    return {_key(n): _registry[_key(n)]["value"] for n in names}


def set_flags(flags: dict[str, Any]) -> None:
    """Set flags explicitly (their source becomes ``"set"``)."""
    with _lock:
        for k, v in flags.items():
            ent = _registry.get(_key(k))
            if ent is None:
                raise KeyError(f"unknown flag {_key(k)!r}")
            ent["value"] = v if isinstance(v, ent["type"]) \
                else ent["type"](v)
            ent["source"] = "set"


class scoped_default:
    """Context manager giving ``name`` another default for the scope.

    It applies only while the flag's value is still the ``define_flag``
    default: an environment variable or a :func:`set_flags` call wins.
    The source stays ``"default"``, and the value is restored on exit
    unless something set the flag explicitly inside the scope."""

    def __init__(self, name: str, value: Any):
        self._name = _key(name)
        self._value = value
        self._applied = False

    def __enter__(self):
        with _lock:
            ent = _registry[self._name]
            self._prev = ent["value"]
            if ent["source"] == "default":
                ent["value"] = ent["type"](self._value)
                self._applied = True
        return self

    def __exit__(self, *exc):
        with _lock:
            ent = _registry[self._name]
            if self._applied and ent["source"] == "default":
                ent["value"] = self._prev
        return False


define_flag("FLAGS_fused_rmsnorm_residual", True,
            "Llama's training stack carries the un-added (hidden, "
            "residual) pair between layers, so every residual add and "
            "the RMSNorm after it are one kernel pair (K3/K4).")
define_flag("FLAGS_fused_linear_cross_entropy", False,
            "The labelled forward's loss through ops.fused_ce (vocab "
            "chunks, never the [N, V] logits); it then returns (None, "
            "loss). hapi.Model.fit(compiled=True) turns it on with "
            "scoped_default.")
define_flag("FLAGS_fused_ce_chunk_v", 1024,
            "Vocab columns per chunk of the fused linear+CE.")
define_flag("FLAGS_recompute_policy", "dots_saveable",
            "What recompute() keeps from its forward: dots_saveable "
            "(the matmul outputs) or nothing_saveable.")
