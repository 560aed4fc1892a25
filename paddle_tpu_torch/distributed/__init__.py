"""``distributed`` of the port: the one-process checkpoints
(``checkpoint``), preemption and the elastic manager
(``fleet.elastic``) and the elastic launcher (``launch``). Submodules
load at first use, so the launcher's imports stay free of torch."""

import importlib

__all__ = ["checkpoint", "fleet", "launch"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
