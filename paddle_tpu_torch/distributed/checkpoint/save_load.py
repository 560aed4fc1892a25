"""Crash-safe sharded checkpoints: the port of
``paddle_tpu/distributed/checkpoint/save_load.py``.

It writes the JAX package's files, so a checkpoint from either package
validates and loads in the other, whatever the number of ranks:

1. **Snapshot.** Each tensor's part on this rank is placed in the global
   tensor by its layout (``metadata.boxes``: a tensor-parallel shard, a
   ZeRO stage-3 flat range as boxes, an owner's optimizer state, or the
   whole tensor). Each distinct box is written by one rank: the ranks
   holding the same part split its first dim between them
   (``metadata.replica_index``), so at dp 2 each rank writes half the
   bytes. The parts are copied to the host before ``save_state_dict``
   returns (a CPU tensor too: the next ``opt.step()`` updates the
   parameters in place).
2. **Stage.** Everything goes into a ``<path>.tmp-<uid>`` staging
   directory, each file through :func:`_atomic_write` (``.part``, fsync,
   size check, rename): ``<name>.r<rank>.s<i>.npy`` shards (bf16 and
   fp8 as integer views) whose offset, local shape, SHA-256 and size
   the rank's ``meta.<rank>.json`` records beside the global shape,
   dtype name and placement; a value that is not a tensor (an epoch,
   ``@step``, a scheduler's numbers) is recorded in every rank's
   metadata, equal on all of them, and the merge takes rank 0's.
3. **Barrier, on the filesystem.** With more than one rank the staging
   directory is shared (``unique_id`` ``"shared"``): the coordinator
   wipes a stale one and stamps a fresh ``ATTEMPT`` token that every
   rank echoes in its ``ack.<rank>`` after its files; the coordinator
   waits for every ack of this attempt (``PADDLE_CKPT_BARRIER_TIMEOUT``,
   300 s, or ``barrier_timeout=``). The other ranks stage again whenever
   the token changes and wait, as long, for the commit of the token they
   acked, so that a rank returning from ``save_state_dict`` finds the
   checkpoint committed. No collective is involved: a dead peer makes
   the save time out uncommitted, it never hangs.
4. **Commit.** The coordinator writes the ``COMMITTED`` sentinel (the
   world size, the metadata files' SHA-256, the topology) and renames
   the staging directory to ``path`` (an existing checkpoint is moved to
   ``<path>.old`` first and deleted after): the rename is the commit
   point. ``keep_last_n`` then removes older committed ``step_N``
   siblings and stale staging directories.

``async_save=True`` returns after the snapshot and stages and commits in
a thread; ``wait_async_save`` joins it and re-raises its failure (or the
next save does). The flight recorder gets a ``checkpoint_phase`` event
at the stage, the barrier and the commit.

Loading verifies the sentinel, the metadata checksums and each shard's
SHA-256 before a byte reaches a tensor, and reshards every target to
its own layout (``reshard.reshard_to_local``: only the shards that
overlap this rank's part are read); the ``elastic/reshard_tensors`` and
``elastic/reshard_ms`` gauges count the targets whose placement differs
from the saved one. Nested dicts are flattened with ``.`` between the
keys. Files are written and read by a pool of threads, one tensor a
task. Rank and world come from ``distributed.env`` (or
``process_group=``).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...profiler import flight_recorder as _frec
from ...profiler import metrics as _pmetrics
from ...utils.retry import retry_call
from .metadata import (boxes, layout_of, placement_of, replica_index,
                       spanning_hcg, to_numpy)
from .reshard import reshard_to_local
from .validation import (
    COMMITTED_SENTINEL, CheckpointCorruptError,
    CheckpointNotCommittedError, _active_stages, _read_file,
    _read_metas, _sha256, gc_checkpoints, is_committed,
    latest_valid_checkpoint, validate_checkpoint)

__all__ = [
    "save_state_dict", "load_state_dict", "wait_async_save",
    "latest_valid_checkpoint", "validate_checkpoint", "is_committed",
    "gc_checkpoints", "load_values", "read_state_dict",
    "CheckpointCorruptError", "CheckpointNotCommittedError",
    "COMMITTED_SENTINEL",
]

_FORMAT_VERSION = 1

#: multi-rank attempt token (module docstring, step 3)
ATTEMPT_FILE = "ATTEMPT"

_pmetrics.declare("elastic/reshard_tensors", "gauge",
                  "tensors laid out for a different mesh during a "
                  "checkpoint load")
_pmetrics.declare("elastic/reshard_ms", "gauge",
                  "wall time of the reshard-on-load pass")


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


# --------------------------------------------------------------------------
# save: snapshot -> staged write -> barrier -> commit
# --------------------------------------------------------------------------

_async_threads = []
_async_errors = []


def _raise_pending_async_error():
    if _async_errors:
        err = _async_errors[0]
        _async_errors.clear()
        raise err


def wait_async_save():
    """Join every outstanding async checkpoint writer and re-raise the
    first failure one of them hit: an async save must not fail silently.
    (If the caller never waits, the error surfaces on the next
    ``save_state_dict`` call instead.)"""
    while _async_threads:
        _async_threads.pop().join()
    _raise_pending_async_error()


def _rank_world(process_group):
    """``(rank, world)`` of the save: the group's, else the joined
    process group's, else one process."""
    if process_group is not None:
        return max(process_group.rank, 0), process_group.nranks
    from .. import env
    if env._dist_ready():
        return env.get_rank(), env.get_world_size()
    return 0, 1


def _written_parts(t, rank, world, hcg):
    """``(global_shape, [(offset, host array)])``: the boxes of this
    rank's tensor ``t`` that it writes (its share of each box among the
    ranks holding the same part), copied to the host."""
    gshape, parts = boxes(t)
    index, count = replica_index(layout_of(t), rank, world, hcg)
    out = []
    for off, shp, view in parts:
        if count > 1:
            if not shp:
                if index:
                    continue
            else:
                a = index * shp[0] // count
                b = (index + 1) * shp[0] // count
                if b <= a:
                    continue
                off = (off[0] + a,) + tuple(off[1:])
                view = view[a:b]
        out.append((off, to_numpy(view.detach().to("cpu", copy=True))[0]))
    return gshape, out


def _snapshot(state_dict, rank, world, hcg):
    """Each entry on the host: ``("value", v)`` or ``("tensor",
    global_shape, dtype, [(offset, array)], placement)``, so the writer
    never touches the live tensors."""
    host = {}
    for name, t in _flat(state_dict).items():
        if not isinstance(t, torch.Tensor):
            host[name] = ("value", t)
            continue
        gshape, parts = _written_parts(t, rank, world, hcg)
        host[name] = ("tensor", gshape, str(t.dtype).removeprefix("torch."),
                      parts, placement_of(t))
    return host


def _barrier_timeout():
    return float(os.environ.get("PADDLE_CKPT_BARRIER_TIMEOUT", "300"))


def _barrier_on_acks(stage, world, attempt, timeout):
    """Commit barrier: the coordinator waits until every rank's ack —
    echoing THIS attempt's token, so a previous crashed attempt's
    leftovers can never satisfy it — has landed in the staging dir. A
    dead peer means the barrier times out and the checkpoint stays
    uncommitted: the safe outcome."""
    deadline = time.time() + timeout
    while True:
        missing = []
        for r in range(world):
            try:
                ok = _read_file(os.path.join(
                    stage, f"ack.{r}")).decode() == attempt
            except OSError:
                ok = False
            if not ok:
                missing.append(r)
        if not missing:
            return
        if time.time() > deadline:
            raise RuntimeError(
                f"checkpoint commit barrier timed out after {timeout}s "
                f"waiting for ranks {missing} to acknowledge attempt "
                f"{attempt}; a peer rank likely died mid-save — "
                f"staging dir {stage} left uncommitted")
        time.sleep(0.05)


def _stage_and_wait(host, stage, final, rank, timeout):
    """A non-coordinator's part: stage this rank's files and its ack for
    the coordinator's ``ATTEMPT`` token, staging again whenever the token
    changes (a rank that came first may have staged into a crashed
    attempt's dir, which the coordinator then wipes and stamps anew),
    until ``final`` is the committed checkpoint of the token it acked:
    a rank that goes on to resume finds the commit."""
    deadline = time.time() + timeout
    tried, acked, err = None, None, None
    while True:
        try:
            if acked is not None and is_committed(final) and _read_file(
                    os.path.join(final, ATTEMPT_FILE)).decode() == acked:
                return
        except OSError:
            pass
        try:
            token = _read_file(os.path.join(stage, ATTEMPT_FILE)).decode()
        except OSError:
            token = None
        if token is not None and token != tried:
            tried = token
            try:
                _write_rank_files(host, stage, rank)
                _atomic_write(os.path.join(stage, f"ack.{rank}"),
                              token.encode())
                acked = token
            except OSError as e:   # wiped under us, or a failing write
                err = e
        if time.time() > deadline:
            what = "the coordinator's ATTEMPT token" if tried is None \
                else f"the commit of attempt {acked}" if acked else \
                f"an ack of attempt {tried} to land ({err})"
            raise RuntimeError(
                f"timed out after {timeout}s waiting for {what} at "
                f"{stage}: a peer likely died mid-save — the checkpoint "
                f"stays uncommitted")
        time.sleep(0.05)


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


def _write_entry(stage, rank, name, item):
    """One entry's shard files and its metadata entry."""
    if item[0] == "value":
        return {"kind": "value", "value": item[1]}
    _, gshape, dtype, parts, placement = item
    safe = name.replace("/", "_")
    shards = []
    for i, (off, arr) in enumerate(parts):
        fname = f"{safe}.r{rank}.s{i}.npy"
        blob = _np_bytes(arr)
        sha = _atomic_write(os.path.join(stage, fname), blob)
        shards.append({"offset": list(off), "local_shape": list(arr.shape),
                       "file": fname, "sha256": sha, "nbytes": len(blob)})
    entry = {"kind": "tensor", "global_shape": list(gshape), "dtype": dtype,
             "shards": shards}
    if placement is not None:
        entry["placement"] = placement
    return entry


def _write_rank_files(host, stage, rank):
    """This rank's shards and ``meta.<rank>.json`` into the staging dir."""
    with _pool() as pool:
        entries = pool.map(lambda kv: _write_entry(stage, rank, *kv),
                           host.items())
        meta = dict(zip(host, entries))
    _atomic_write(os.path.join(stage, f"meta.{rank}.json"),
                  json.dumps(meta).encode())


def _write_checkpoint(host, path, coordinator_rank, uid, keep_last_n,
                      rank, world, barrier_timeout=None):
    final = os.path.normpath(path)
    stage = f"{final}.tmp-{uid}"
    timeout = _barrier_timeout() if barrier_timeout is None \
        else float(barrier_timeout)
    _active_stages.add(stage)
    # flight-recorder breadcrumbs: a save killed mid-protocol leaves
    # the phase it died in inside the crash bundle
    _frec.record_event("checkpoint_phase", phase="stage", path=final,
                       rank=rank)
    try:
        if world <= 1:
            # one process: the uid is fresh, no stale staging to race
            os.makedirs(stage, exist_ok=True)
            _write_rank_files(host, stage, rank)
        elif rank == coordinator_rank:
            # the shared staging dir may hold a crashed attempt's files
            # whose metadata would satisfy the barrier and commit mixed
            # old/new rank data: wipe it and stamp a fresh token every
            # rank must echo (a stale shard surviving the wipe is
            # harmless: load reads only the files the metadata names)
            if os.path.isdir(stage):
                shutil.rmtree(stage, ignore_errors=True)
            os.makedirs(stage, exist_ok=True)
            attempt = uuid.uuid4().hex
            _atomic_write(os.path.join(stage, ATTEMPT_FILE),
                          attempt.encode())
            _write_rank_files(host, stage, rank)
            _atomic_write(os.path.join(stage, f"ack.{rank}"),
                          attempt.encode())
        else:
            _stage_and_wait(host, stage, final, rank, timeout)
            return final
        if world > 1:
            _frec.record_event("checkpoint_phase", phase="barrier",
                               path=final, rank=rank)
            _barrier_on_acks(stage, world, attempt, timeout)
        meta_shas = {}
        for r in range(world):
            mname = f"meta.{r}.json"
            meta_shas[mname] = _sha256(
                _read_file(os.path.join(stage, mname)))
        meshes = []
        for item in host.values():
            if item[0] == "tensor" and item[4]:
                key = [item[4]["mesh_shape"], item[4]["mesh_axes"]]
                if key not in meshes:
                    meshes.append(key)
        sentinel = {"format": _FORMAT_VERSION, "world_size": world,
                    "metas": meta_shas,
                    "topology": {"process_count": world,
                                 "device_count": world, "meshes": meshes}}
        _atomic_write(os.path.join(stage, COMMITTED_SENTINEL),
                      json.dumps(sentinel).encode())
        _fsync_dir(stage)
        _commit_rename(stage, final)
        _frec.record_event("checkpoint_phase", phase="committed",
                           path=final, rank=rank)
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


def _write_async(*args, **kwargs):
    try:
        _write_checkpoint(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — re-raised at the join
        _async_errors.append(e)


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False,
                    keep_last_n=None, barrier_timeout=None):
    """Crash-safe sharded save of ``state_dict`` (nested dicts of tensors
    and JSON values) to the directory ``path`` (module docstring). Every
    rank of the world (or of ``process_group``) calls it.

    ``unique_id`` names the staging attempt; with more than one rank and
    none given, the ranks share the id ``"shared"`` (they stage into one
    directory without communicating), else it is random.
    ``async_save=True`` snapshots to the host, then stages and commits in
    a background thread; failures re-raise from ``wait_async_save`` or
    the next save. ``keep_last_n`` garbage-collects older committed
    ``step_N`` siblings (and stale staging dirs) after the commit.
    ``barrier_timeout`` bounds the commit barrier of this save (a
    preempted worker has a grace window, not 300 s). Returns the path
    (None for an async save)."""
    _raise_pending_async_error()
    rank, world = _rank_world(process_group)
    hcg = spanning_hcg() if process_group is None else None
    host = _snapshot(state_dict, rank, world, hcg)
    if unique_id is not None:
        uid = str(unique_id)
    elif world > 1:
        uid = "shared"
    else:
        uid = uuid.uuid4().hex[:8]
    args = (host, path, coordinator_rank, uid, keep_last_n, rank, world)
    if async_save:
        th = threading.Thread(target=_write_async, args=args,
                              kwargs={"barrier_timeout": barrier_timeout},
                              daemon=False)
        th.start()
        _async_threads.append(th)
        return None
    return _write_checkpoint(*args, barrier_timeout=barrier_timeout)


# --------------------------------------------------------------------------
# load: validate -> reshard
# --------------------------------------------------------------------------

def _assemble(entry, path, name, validate=True):
    """One whole tensor of the checkpoint (a CPU tensor of its stored
    dtype): the whole-box case of the reshard assembler, so checksums,
    missing shards and coverage are checked in one place."""
    try:
        return reshard_to_local(entry, path, entry["global_shape"],
                                validate=validate)
    except CheckpointCorruptError as e:
        raise CheckpointCorruptError(f"tensor {name}: {e}")


@torch.no_grad()
def load_state_dict(state_dict, path, process_group=None, unique_id=None,
                    offload=False, validate=True):
    """In-place load into ``state_dict``'s tensors, each resharded to its
    own layout (this rank's part: ``reshard.reshard_to_local``), keeping
    its device and dtype (the stored values are cast as ``copy_`` casts).
    With ``validate=True`` (default) the checkpoint must be committed and
    every byte read is verified against its SHA-256: the result is
    bit-exact or an exception. ``validate=False`` skips both checks for
    dirs saved before the sentinel existed. ``process_group``,
    ``unique_id`` and ``offload`` are taken for Paddle's signature; each
    rank reads what it needs from the shared directory."""
    if validate:
        validate_checkpoint(path)
    metas = _read_metas(path)
    todo = [(name, t) for name, t in _flat(state_dict).items()
            if isinstance(t, torch.Tensor)
            and metas.get(name, {}).get("kind") == "tensor"]
    t0 = time.perf_counter()

    def load(item):
        name, t = item
        try:
            return reshard_to_local(metas[name], path, t.shape,
                                    layout_of(t), validate=validate)
        except CheckpointCorruptError as e:
            raise CheckpointCorruptError(f"tensor {name}: {e}")

    with _pool() as pool:
        for (_, t), src in zip(todo, pool.map(load, todo)):
            t.copy_(src)
    moved = sum(metas[name].get("placement") != placement_of(t)
                for name, t in todo)
    if moved:
        # a cross-layout resume's reshard cost shows as a gauge, not as
        # a gap in the resume's time
        reg = _pmetrics.get_registry()
        reg.gauge("elastic/reshard_tensors").set(moved)
        reg.gauge("elastic/reshard_ms").set(
            round((time.perf_counter() - t0) * 1e3, 3))
    return state_dict


def load_values(path, validate=True):
    """The entries that are not tensors (epoch, step counters, an LR
    scheduler's numbers) as a nested dict."""
    if validate:
        validate_checkpoint(path)
    vals = {k: e["value"] for k, e in _read_metas(path).items()
            if e.get("kind") == "value"}
    return _unflatten(vals)


def read_state_dict(path, prefix=None, validate=True, like=None):
    """A checkpoint (or the subtree under ``prefix``) as a flat dict of
    CPU tensors in their stored dtypes and values, without a target: the
    resume path of state made lazily (optimizer slots). Keys are the flat
    dotted names with the prefix stripped; leaf names may hold dots
    themselves, so re-nesting is left to the caller. ``like(key,
    global_shape)`` may name this rank's part of a tensor: ``(shape,
    layout)`` reads that part only (``reshard_to_local``), False leaves
    the key out, None reads the whole tensor."""
    if validate:
        validate_checkpoint(path)
    pre = "" if prefix is None else prefix + "."
    items = []
    for name, entry in _read_metas(path).items():
        if not name.startswith(pre):
            continue
        part = None
        if like is not None and entry.get("kind") == "tensor":
            part = like(name[len(pre):], tuple(entry["global_shape"]))
            if part is False:
                continue
        items.append((name, entry, part))

    def read(item):
        name, entry, part = item
        if entry.get("kind") == "value":
            return entry["value"]
        if part is None:
            return _assemble(entry, path, name, validate=validate)
        return reshard_to_local(entry, path, part[0], part[1],
                                validate=validate)
    with _pool() as pool:
        return {name[len(pre):]: v
                for (name, _, _), v in zip(items, pool.map(read, items))}
