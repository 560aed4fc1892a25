"""Crash-safe checkpoints of one process (``save_load``), their
validation, discovery and retention (``validation``): the JAX package's
files and protocol."""

from .save_load import (
    COMMITTED_SENTINEL, CheckpointCorruptError, CheckpointNotCommittedError,
    gc_checkpoints, is_committed, latest_valid_checkpoint, load_state_dict,
    load_values, read_state_dict, save_state_dict, validate_checkpoint)
from .validation import shards_intact

__all__ = ["save_state_dict", "load_state_dict", "latest_valid_checkpoint",
           "validate_checkpoint", "is_committed", "gc_checkpoints",
           "load_values", "read_state_dict", "CheckpointCorruptError",
           "CheckpointNotCommittedError", "COMMITTED_SENTINEL",
           "shards_intact"]
