"""Crash-safe checkpoints of one process: a port of the one-process path
of ``paddle_tpu/distributed/checkpoint/save_load.py``.

It writes the JAX package's files, so a checkpoint from either package
validates and loads in the other:

1. everything goes into a ``<path>.tmp-<uid>`` staging directory, each
   file through :func:`_atomic_write` (``.part``, fsync, size check,
   rename);
2. each tensor is one ``.npy`` shard whose SHA-256 and size the rank's
   metadata ``meta.0.json`` records beside its global shape and dtype
   name (bf16 and fp8 as integer views: ``metadata.py``); a value that
   is not a tensor (an epoch, ``@step``, a scheduler's numbers) is
   recorded in the metadata itself;
3. the ``COMMITTED`` sentinel records the metadata's SHA-256 and the
   staging directory is renamed to ``path`` (an existing checkpoint is
   moved to ``<path>.old`` first and deleted after): the rename is the
   commit point;
4. ``keep_last_n`` then removes older committed ``step_N`` siblings and
   stale staging directories (``validation.gc_checkpoints``).

Loading verifies the sentinel, the metadata checksums and each shard's
SHA-256 before a byte reaches a tensor. Nested dicts are flattened with
``.`` between the keys. The tensors' files are written and read by a
pool of threads (hashing, copies and file I/O release the interpreter
lock), one tensor a task; the files are those of a one-thread save.
Multi-rank saves (barriers, ``ATTEMPT`` tokens), ``async_save`` and
resharding on load are not ported yet; a shard list that tiles a tensor
(a multi-rank JAX save) is assembled.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...utils.retry import retry_call
from .metadata import from_numpy, to_numpy
from .validation import (
    COMMITTED_SENTINEL, CheckpointCorruptError,
    CheckpointNotCommittedError, _active_stages, _read_file,
    _read_metas, _sha256, gc_checkpoints, is_committed,
    latest_valid_checkpoint, validate_checkpoint)

__all__ = [
    "save_state_dict", "load_state_dict", "latest_valid_checkpoint",
    "validate_checkpoint", "is_committed", "gc_checkpoints", "load_values",
    "read_state_dict", "CheckpointCorruptError",
    "CheckpointNotCommittedError", "COMMITTED_SENTINEL",
]

_FORMAT_VERSION = 1


def _pool():
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _flat(state_dict, prefix=""):
    out = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flatmap):
    out = {}
    for k, v in flatmap.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _fsync_dir(path):
    """Best-effort directory fsync so the commit rename survives power
    loss, not just process death (no-op where unsupported)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path, data):
    """THE write primitive for checkpoint files: ``data`` (bytes-like)
    staged to ``<path>.part``, flushed and fsynced, its size checked,
    renamed into place; transient I/O errors retried with bounded
    backoff. Returns the SHA-256 of ``data``."""
    part = path + ".part"

    def _write():
        with open(part, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        size = os.stat(part).st_size
        if size != len(data):
            import errno as _e
            raise OSError(_e.EIO,
                          f"short write: {size} != {len(data)}", part)
        os.replace(part, path)

    retry_call(_write)
    return _sha256(data)


def _np_bytes(arr):
    """The ``.npy`` file of ``arr``, as a view of the buffer it was
    written into (no second copy)."""
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getbuffer()


def _commit_rename(stage, final):
    """Promote the staging dir to the final path; an existing non-empty
    checkpoint is moved aside to ``<final>.old`` first and deleted only
    after the rename lands, so a crash between the two renames leaves a
    committed backup that ``latest_valid_checkpoint`` considers."""
    backup = final + ".old"

    def _rename():
        if os.path.isdir(final):
            if os.listdir(final):
                shutil.rmtree(backup, ignore_errors=True)
                os.rename(final, backup)
            else:
                os.rmdir(final)
        os.rename(stage, final)

    retry_call(_rename)
    shutil.rmtree(backup, ignore_errors=True)


def _write_entry(stage, name, t):
    """One state-dict entry: a tensor's shard file and its metadata
    entry, or a value's entry."""
    if not isinstance(t, torch.Tensor):
        return {"kind": "value", "value": t}
    arr, dtype = to_numpy(t)
    fname = f"{name.replace('/', '_')}.r0.s0.npy"
    blob = _np_bytes(arr)
    sha = _atomic_write(os.path.join(stage, fname), blob)
    return {"kind": "tensor", "global_shape": list(t.shape), "dtype": dtype,
            "shards": [{"offset": [0] * t.dim(),
                        "local_shape": list(t.shape), "file": fname,
                        "sha256": sha, "nbytes": len(blob)}]}


def _write_files(state_dict, stage):
    """Each tensor's shard and the metadata into ``stage``; returns the
    metadata's bytes."""
    flat = _flat(state_dict)
    with _pool() as pool:
        entries = pool.map(lambda kv: _write_entry(stage, *kv),
                           flat.items())
        meta = dict(zip(flat, entries))
    blob = json.dumps(meta).encode()
    _atomic_write(os.path.join(stage, "meta.0.json"), blob)
    return blob


def save_state_dict(state_dict, path, unique_id=None, keep_last_n=None):
    """Crash-safe save of ``state_dict`` (nested dicts of tensors and
    JSON values) to the directory ``path`` (module docstring).
    ``unique_id`` names the staging attempt (a random one by default);
    ``keep_last_n`` garbage-collects older committed ``step_N``
    siblings and stale staging dirs after the commit. Tensors are read
    to the host before the first file is written."""
    final = os.path.normpath(path)
    uid = str(unique_id) if unique_id is not None else uuid.uuid4().hex[:8]
    stage = f"{final}.tmp-{uid}"
    _active_stages.add(stage)
    try:
        os.makedirs(stage, exist_ok=True)
        meta = _write_files(state_dict, stage)
        sentinel = {"format": _FORMAT_VERSION, "world_size": 1,
                    "metas": {"meta.0.json": _sha256(meta)},
                    "topology": {"process_count": 1, "device_count": 1,
                                 "meshes": []}}
        _atomic_write(os.path.join(stage, COMMITTED_SENTINEL),
                      json.dumps(sentinel).encode())
        _fsync_dir(stage)
        _commit_rename(stage, final)
    finally:
        _active_stages.discard(stage)
    parent = os.path.dirname(final) or "."
    _fsync_dir(parent)
    # same-step staging leftovers from earlier crashed attempts
    base = os.path.basename(final)
    try:
        for name in os.listdir(parent):
            full = os.path.join(parent, name)
            if name.startswith(base + ".tmp-") \
                    and full not in _active_stages:
                shutil.rmtree(full, ignore_errors=True)
    except OSError:
        pass
    if keep_last_n is not None:
        gc_checkpoints(parent, keep_last_n)
    return final


def _assemble(entry, path, name, validate=True):
    """One tensor of the checkpoint, a CPU tensor of its stored dtype,
    from the shard files that tile it (each checksum-verified)."""
    shape = tuple(entry["global_shape"])
    out = None
    covered = 0
    for sh in entry["shards"]:
        fname = sh["file"]
        try:
            blob = _read_file(os.path.join(path, fname))
        except FileNotFoundError:
            raise CheckpointCorruptError(
                f"tensor {name}: {path}/{fname}: shard file missing")
        expect = sh.get("sha256")
        if validate and expect and _sha256(blob) != expect:
            raise CheckpointCorruptError(
                f"tensor {name}: {path}/{fname}: shard checksum mismatch "
                f"(expected sha256 {expect}, got {_sha256(blob)}) — "
                f"refusing to load corrupt data")
        piece = from_numpy(np.load(io.BytesIO(blob)), entry["dtype"])
        if out is None:
            out = torch.empty(shape, dtype=piece.dtype)
        box = tuple(slice(o, o + n) for o, n in zip(sh["offset"],
                                                     piece.shape))
        out[box] = piece
        covered += piece.numel()
    total = int(np.prod(shape)) if shape else 1
    if out is None or covered < total:
        raise CheckpointCorruptError(
            f"{path}: shards cover only {covered}/{total} elements of "
            f"tensor {name} {list(shape)}; refusing the partial state")
    return out


@torch.no_grad()
def load_state_dict(state_dict, path, validate=True):
    """In-place load into ``state_dict``'s tensors (each keeps its device
    and dtype; the stored values are cast as ``copy_`` casts). With
    ``validate=True`` (default) the checkpoint must be committed and
    every byte read is verified against its SHA-256: the result is
    bit-exact or an exception. ``validate=False`` skips both checks for
    dirs saved before the sentinel existed."""
    if validate:
        validate_checkpoint(path)
    metas = _read_metas(path)
    todo = [(name, t) for name, t in _flat(state_dict).items()
            if isinstance(t, torch.Tensor)
            and metas.get(name, {}).get("kind") == "tensor"]
    with _pool() as pool:
        loaded = pool.map(lambda nt: _assemble(metas[nt[0]], path, nt[0],
                                               validate=validate), todo)
        for (_, t), src in zip(todo, loaded):
            t.copy_(src)
    return state_dict


def load_values(path, validate=True):
    """The entries that are not tensors (epoch, step counters, an LR
    scheduler's numbers) as a nested dict."""
    if validate:
        validate_checkpoint(path)
    vals = {k: e["value"] for k, e in _read_metas(path).items()
            if e.get("kind") == "value"}
    return _unflatten(vals)


def read_state_dict(path, prefix=None, validate=True):
    """A checkpoint (or the subtree under ``prefix``) as a flat dict of
    CPU tensors in their stored dtypes and values, without a target:
    the resume path of state made lazily (optimizer slots). Keys are
    the flat dotted names with the prefix stripped; leaf names may hold
    dots themselves, so re-nesting is left to the caller."""
    if validate:
        validate_checkpoint(path)
    pre = "" if prefix is None else prefix + "."
    items = [(name, entry) for name, entry in _read_metas(path).items()
             if name.startswith(pre)]

    def read(item):
        name, entry = item
        if entry.get("kind") == "value":
            return entry["value"]
        return _assemble(entry, path, name, validate=validate)
    with _pool() as pool:
        return {name[len(pre):]: v
                for (name, _), v in zip(items, pool.map(read, items))}
