"""Crash-safe checkpoints of one process (``save_load``), their
validation, discovery and retention (``validation``): the JAX package's
files and protocol. ``validation`` imports no torch (the launcher finds
the newest committed checkpoint through it); the names below load
``save_load`` at first use."""

import importlib

__all__ = ["save_state_dict", "load_state_dict", "latest_valid_checkpoint",
           "validate_checkpoint", "is_committed", "gc_checkpoints",
           "load_values", "read_state_dict", "CheckpointCorruptError",
           "CheckpointNotCommittedError", "COMMITTED_SENTINEL",
           "shards_intact"]


def __getattr__(name):
    if name == "shards_intact":
        from .validation import shards_intact
        return shards_intact
    if name in __all__:
        return getattr(importlib.import_module(".save_load", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
