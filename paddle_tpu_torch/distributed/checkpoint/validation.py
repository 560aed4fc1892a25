"""Checkpoint validation, discovery and retention: the port's own copy of
``paddle_tpu/distributed/checkpoint/validation.py`` (``save_load.py``
has the writer). A checkpoint either package writes validates in the
other.

Everything here needs only os/json/hashlib. The protocol contract
being checked: a committed checkpoint carries a ``COMMITTED`` sentinel
recording the SHA-256 of every rank's metadata file, and each metadata
entry records the SHA-256 of every shard file it references.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from ...utils.retry import retry_call

__all__ = ["is_committed", "validate_checkpoint",
           "latest_valid_checkpoint", "gc_checkpoints", "shards_intact",
           "CheckpointCorruptError", "CheckpointNotCommittedError",
           "COMMITTED_SENTINEL"]

#: sentinel file whose presence (written last, pre-rename) marks a
#: fully-committed checkpoint directory
COMMITTED_SENTINEL = "COMMITTED"

#: staging dirs of saves currently in flight in THIS process (async
#: writers register here) — retention GC must never sweep them, even
#: when a newer step commits first
_active_stages = set()


class CheckpointCorruptError(RuntimeError):
    """The checkpoint exists but fails validation (checksum mismatch,
    missing metadata/shard, unreadable sentinel)."""


class CheckpointNotCommittedError(CheckpointCorruptError):
    """The directory never reached the commit point (no ``COMMITTED``
    sentinel): a torn / in-progress save, not a loadable checkpoint."""


def _sha256(data):
    return hashlib.sha256(data).hexdigest()


def _read_file(path):
    def _read():
        with open(path, "rb") as f:
            return f.read()
    return retry_call(_read)


def _read_metas(path):
    """All rank metadata files of a checkpoint, MERGED per tensor.

    A multi-process save writes one ``meta.<rank>.json`` per rank, each
    listing only the shards that rank owned; loading on a different
    world size (the elastic-resume case) must see the union of every
    rank's shards, so tensor entries with the same name merge their
    shard lists. Replicated copies (same global offset written by
    several ranks) dedupe to the first occurrence — coordinator rank 0
    sorts first, so its copy wins."""
    metas = {}
    for fn in sorted(os.listdir(path)):
        if not (fn.startswith("meta.") and fn.endswith(".json")):
            continue
        for name, entry in json.loads(_read_file(
                os.path.join(path, fn)).decode()).items():
            cur = metas.get(name)
            if cur is None:
                metas[name] = entry
            elif cur.get("kind") == "tensor" \
                    and entry.get("kind") == "tensor":
                seen = {tuple(s["offset"]) for s in cur["shards"]}
                for sh in entry.get("shards", []):
                    if tuple(sh["offset"]) not in seen:
                        seen.add(tuple(sh["offset"]))
                        cur["shards"].append(sh)
    return metas


def _step_of(name):
    """Step number encoded in a ``step_N`` basename, else -1."""
    if name.startswith("step_"):
        try:
            return int(name[len("step_"):])
        except ValueError:
            pass
    return -1


def is_committed(path):
    """True iff ``path`` carries the ``COMMITTED`` sentinel."""
    return os.path.isfile(os.path.join(path, COMMITTED_SENTINEL))


def shards_intact(path):
    """Cheap (stat-level, no hashing) check that every shard file the
    metadata references exists with its recorded size. Catches the
    shard-lost-under-a-clean-sentinel rot that shallow validation
    (metadata checksums only) cannot see, at a fraction of ``deep``
    validation's re-hash cost — the discovery/retention middle
    ground."""
    try:
        for entry in _read_metas(path).values():
            if entry.get("kind") != "tensor":
                continue
            for sh in entry["shards"]:
                fpath = os.path.join(path, sh["file"])
                try:
                    size = os.stat(fpath).st_size
                except OSError:
                    return False
                expect = sh.get("nbytes")
                if expect is not None and size != int(expect):
                    return False
    except (OSError, ValueError, KeyError):
        return False
    return True


def validate_checkpoint(path, deep=False):
    """Raise unless ``path`` is a committed checkpoint whose metadata
    files match the sentinel's checksums; with ``deep=True`` also
    verify every shard file's SHA-256. Returns the parsed sentinel."""
    if not os.path.isdir(path):
        raise CheckpointNotCommittedError(
            f"{path}: not a checkpoint directory")
    spath = os.path.join(path, COMMITTED_SENTINEL)
    if not os.path.isfile(spath):
        raise CheckpointNotCommittedError(
            f"{path}: no {COMMITTED_SENTINEL} sentinel — the save never "
            f"reached its commit point (torn or in-progress checkpoint)")
    try:
        sentinel = json.loads(_read_file(spath).decode())
    except ValueError as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable {COMMITTED_SENTINEL} sentinel: {e}")
    for mname, expect in (sentinel.get("metas") or {}).items():
        mpath = os.path.join(path, mname)
        if not os.path.isfile(mpath):
            raise CheckpointCorruptError(
                f"{path}: committed sentinel names {mname} but the "
                f"file is missing")
        actual = _sha256(_read_file(mpath))
        if expect and actual != expect:
            raise CheckpointCorruptError(
                f"{path}/{mname}: metadata checksum mismatch "
                f"(expected sha256 {expect}, got {actual})")
    if deep:
        for name, entry in _read_metas(path).items():
            if entry.get("kind") != "tensor":
                continue
            for sh in entry["shards"]:
                fpath = os.path.join(path, sh["file"])
                if not os.path.isfile(fpath):
                    raise CheckpointCorruptError(
                        f"{path}: missing shard {sh['file']} of {name}")
                expect = sh.get("sha256")
                if expect:
                    actual = _sha256(_read_file(fpath))
                    if actual != expect:
                        raise CheckpointCorruptError(
                            f"{path}/{sh['file']}: shard checksum "
                            f"mismatch (expected sha256 {expect}, got "
                            f"{actual})")
    return sentinel


def latest_valid_checkpoint(root, deep=False):
    """Newest ``step_N`` subdirectory of ``root`` that is committed,
    passes validation, and has every referenced shard file present at
    its recorded size (:func:`shards_intact` — so a shard lost under a
    clean sentinel is skipped without ``deep``'s re-hash cost); torn,
    in-progress, and corrupt checkpoints are skipped, so elastic
    restart / ``Model.fit(resume=True)`` always lands on the last
    *good* step. ``step_N.old`` move-aside backups (an overwrite
    crashed between its two renames) are considered after their plain
    sibling, so that crash window cannot lose the newest committed
    state. Returns None when nothing valid exists."""
    if not os.path.isdir(root):
        return None
    cands = []
    for name in os.listdir(root):
        full = os.path.join(root, name)
        if not os.path.isdir(full):
            continue
        if name.endswith(".old"):
            s = _step_of(name[:-len(".old")])
            rank = 0  # backup: tried after the plain dir of the step
        else:
            s = _step_of(name)
            rank = 1
        if s >= 0:
            cands.append((s, rank, full))
    for _, _, full in sorted(cands, reverse=True):
        try:
            validate_checkpoint(full, deep=deep)
        except CheckpointCorruptError:
            continue
        if shards_intact(full):
            return full
    return None


def gc_checkpoints(root, keep_last_n, clean_stale=True):
    """Retention: keep the newest ``keep_last_n`` *committed*
    ``step_N`` checkpoints under ``root``; delete older committed
    steps, plus (``clean_stale``) staging dirs, torn step dirs, and
    ``.old`` move-aside backups that are older than the newest
    committed step (never anything newer — that may be a save in
    progress — and never a staging dir this process is still writing).

    A sentinel alone is NOT proof a checkpoint is resumable (a shard
    can rot or go missing under a sentinel that still reads clean), so
    retention additionally pins the newest checkpoint that passes
    validation AND has all shard files present at their recorded
    sizes (:func:`shards_intact`): it is never deleted, even when the keep window is
    filled by newer committed-but-corrupt steps and a later save is
    still staging. GC racing an in-flight save must never leave zero
    resumable checkpoints — if that in-flight save dies, the pinned
    step is what the elastic relaunch resumes from.

    Returns the removed paths."""
    if not os.path.isdir(root):
        return []
    committed = []
    for name in os.listdir(root):
        full = os.path.join(root, name)
        s = _step_of(name)
        if s >= 0 and os.path.isdir(full) and is_committed(full):
            committed.append((s, full))
    committed.sort(reverse=True)
    # each candidate is validated at most once per GC pass (the pin
    # loop and the .old sweep would otherwise re-read/re-hash the same
    # metadata — wasted time inside the bounded emergency-save window)
    resumable_memo = {}

    def _resumable(p):
        if p not in resumable_memo:
            try:
                validate_checkpoint(p)
                resumable_memo[p] = shards_intact(p)
            except CheckpointCorruptError:
                resumable_memo[p] = False
        return resumable_memo[p]

    newest_valid = next(
        (full for _, full in committed if _resumable(full)), None)
    removed = []
    for _, full in committed[max(0, int(keep_last_n)):]:
        if full == newest_valid:
            continue  # the last resumable state — never GC it
        shutil.rmtree(full, ignore_errors=True)
        removed.append(full)
    if clean_stale:
        newest = committed[0][0] if committed else -1
        for name in os.listdir(root):
            full = os.path.join(root, name)
            if not os.path.isdir(full) or full in removed:
                continue
            if full in _active_stages:
                continue  # a live writer in this process owns it
            if ".tmp-" in name:
                s = _step_of(name.split(".tmp-")[0])
                if 0 <= s <= newest:
                    shutil.rmtree(full, ignore_errors=True)
                    removed.append(full)
            elif name.endswith(".old"):
                s = _step_of(name[:-len(".old")])
                plain = full[:-len(".old")]
                # the backup may be the only VALID copy of its step: a
                # sentinel on the plain dir is not enough, it must
                # actually validate (metas AND shard files present)
                # before its backup is swept
                plain_ok = is_committed(plain) and _resumable(plain)
                if 0 <= s <= newest and plain_ok:
                    shutil.rmtree(full, ignore_errors=True)
                    removed.append(full)
            else:
                s = _step_of(name)
                if 0 <= s < newest and not is_committed(full):
                    shutil.rmtree(full, ignore_errors=True)
                    removed.append(full)
    return removed
