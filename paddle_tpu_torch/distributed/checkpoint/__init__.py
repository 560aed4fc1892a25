"""Crash-safe sharded checkpoints (``save_load``), resharding on load
(``reshard``), the layouts of a rank's tensors (``metadata``), and their
validation, discovery and retention (``validation``): the JAX package's
files and protocol. ``validation`` imports no torch (the launcher finds
the newest committed checkpoint through it); the names below load the
other modules at first use."""

import importlib

_NAMES = {
    ".save_load": ("save_state_dict", "load_state_dict", "wait_async_save",
                   "latest_valid_checkpoint", "validate_checkpoint",
                   "is_committed", "gc_checkpoints", "load_values",
                   "read_state_dict", "CheckpointCorruptError",
                   "CheckpointNotCommittedError", "COMMITTED_SENTINEL"),
    ".validation": ("shards_intact",),
    ".metadata": ("placement_of", "Layout"),
    ".reshard": ("assemble_slice", "reshard_to_local",
                 "checkpoint_topology", "overlapping_shards"),
}
_LAZY = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
