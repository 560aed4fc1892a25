"""Resharding on load: the port of
``paddle_tpu/distributed/checkpoint/reshard.py``. It assembles exactly
the part of a tensor that this rank holds in the *loading* layout from
whatever shards the *saving* layout wrote.

The saved metadata records each shard's global offset and local shape
(and the saving topology and each tensor's placement); this module is
the load-side inverse. :func:`reshard_to_local` walks the boxes of the
rank's tensor in its loading layout (``metadata.boxes``: the rank's
tensor-parallel shard, its stage-3 flat range as boxes, or the whole
tensor), reads ONLY the saved shards that overlap them
(:func:`assemble_slice`), verifies each one's SHA-256 once, and fills
the local tensor: the global tensor is never made and files that do not
overlap are never opened. mp, dp and ZeRO degrees change in either
direction: a coarser target reads several saved shards, a finer one a
sub-slice of one.

numpy has no bf16 or fp8, so shards of those dtypes are assembled as
their integer views (the bits, unchanged) and turned into torch dtypes
by the caller (``metadata.from_numpy``). Incomplete coverage (a missing
rank's shards) is a :class:`CheckpointCorruptError`, never a zero fill.
"""

from __future__ import annotations

import io
import os

import numpy as np
import torch

from ...utils.retry import retry_call
from .metadata import NONNATIVE_DTYPES, boxes, from_numpy
from .validation import (CheckpointCorruptError, _read_metas, _sha256,
                         validate_checkpoint)

__all__ = ["assemble_slice", "reshard_to_local", "checkpoint_topology",
           "overlapping_shards"]


def _np_dtype(dtype_str):
    """The numpy dtype a stored dtype is held in: bf16 and fp8 as the
    unsigned integers of their width."""
    if dtype_str in NONNATIVE_DTYPES:
        return np.dtype(np.uint16 if dtype_str == "bfloat16" else np.uint8)
    return np.dtype(dtype_str)


def _read_file(path):
    """A file's bytes in a writable buffer (an array made on it needs no
    copy to be writable); transient I/O errors retried."""
    def _read():
        with open(path, "rb") as f:
            buf = bytearray(os.fstat(f.fileno()).st_size)
            n = f.readinto(buf)
        if n != len(buf):
            raise OSError(f"short read: {n} != {len(buf)}", path)
        return buf
    return retry_call(_read)


def _npy_array(buf):
    """The array of an ``.npy`` file's bytes, on them (no copy)."""
    fmt = np.lib.format
    f = io.BytesIO(buf)
    version = fmt.read_magic(f)
    if version not in ((1, 0), (2, 0)):
        return np.load(f)
    shape, fortran, dtype = (fmt.read_array_header_1_0 if version == (1, 0)
                             else fmt.read_array_header_2_0)(f)
    arr = np.frombuffer(buf, dtype=dtype, count=int(np.prod(shape)),
                        offset=f.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def _load_shard(path, sh, dtype_str, validate, cache):
    """One shard file as a numpy array, checksum-verified at most once
    per reshard call (``cache`` maps file -> verified array: several
    boxes of the target often slice the same shard)."""
    fname = sh["file"]
    arr = cache.get(fname) if cache is not None else None
    if arr is not None:
        return arr
    try:
        blob = _read_file(os.path.join(path, fname))
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"{path}/{fname}: shard file missing — a rank's shards "
            f"never landed (partial save) or were deleted; refusing "
            f"the torn checkpoint")
    expect = sh.get("sha256")
    if validate and expect:
        actual = _sha256(blob)
        if actual != expect:
            raise CheckpointCorruptError(
                f"{path}/{fname}: shard checksum mismatch (expected "
                f"sha256 {expect}, got {actual}) — refusing to load "
                f"corrupt data")
    arr = _npy_array(blob)
    if cache is not None:
        cache[fname] = arr
    return arr


def overlapping_shards(entry, starts, stops):
    """The saved shards intersecting the global box [starts, stops),
    as (shard_meta, src_slices, dst_slices) triples — src indexes the
    shard file's array, dst indexes the assembled output box."""
    out = []
    for sh in entry["shards"]:
        off = sh["offset"]
        loc = sh["local_shape"]
        src, dst = [], []
        empty = False
        for d, (a, b) in enumerate(zip(starts, stops)):
            lo = max(a, off[d])
            hi = min(b, off[d] + loc[d])
            if hi <= lo:
                empty = True
                break
            src.append(slice(lo - off[d], hi - off[d]))
            dst.append(slice(lo - a, hi - a))
        if not empty:
            out.append((sh, tuple(src), tuple(dst)))
    return out


def assemble_slice(entry, path, starts, stops, validate=True, cache=None):
    """The global box [starts, stops) of one tensor entry (a numpy array
    of the stored dtype, bf16/fp8 as integer views) from the shard files
    that overlap it — files that do not are never opened. Raises
    :class:`CheckpointCorruptError` if the saved shards do not cover the
    box (the some-ranks-committed torn shape)."""
    shape = tuple(int(b - a) for a, b in zip(starts, stops))
    covered = 0
    total = int(np.prod(shape)) if shape else 1
    hits = overlapping_shards(entry, starts, stops)
    if len(hits) == 1 and all(d.stop - d.start == n
                              for d, n in zip(hits[0][2], shape)):
        # one shard holds the whole box: its part, without a copy
        sh, src, _ = hits[0]
        return _load_shard(path, sh, entry["dtype"], validate, cache)[src]
    out = np.zeros(shape, dtype=_np_dtype(entry["dtype"]))
    for sh, src, dst in hits:
        data = _load_shard(path, sh, entry["dtype"], validate, cache)
        out[dst] = data[src]
        covered += int(np.prod([s.stop - s.start for s in dst])) \
            if dst else 1
    # shards are non-overlapping tiles of the global array (replicated
    # copies dedupe at metadata-merge time), so clipped volumes sum to
    # the box volume exactly when coverage is complete
    if covered < total:
        raise CheckpointCorruptError(
            f"{path}: shards cover only {covered}/{total} elements of "
            f"the requested slice of a {entry['global_shape']} tensor "
            f"— a rank's shards are missing (torn multi-rank save); "
            f"refusing the partial state")
    return out


def reshard_to_local(entry, path, shape, layout=None, validate=True,
                     cache=None):
    """This rank's tensor of ``shape`` under ``layout`` (the LOADING
    layout; None: the whole tensor), a CPU tensor of the stored dtype,
    assembled from the shards that overlap its boxes only. A stage-3
    slice's padding stays zero."""
    out = torch.empty(tuple(shape), dtype=getattr(torch, entry["dtype"]),
                      device="meta")
    gshape, parts = boxes(out, layout)
    if list(gshape) != list(entry["global_shape"]):
        raise ValueError(
            f"a tensor of global shape {list(gshape)} in the loading "
            f"layout cannot take the saved {entry['global_shape']}")
    cache = {} if cache is None else cache
    if layout is None or layout.flat is None:
        # one box, the whole tensor: the assembled array itself
        off, shp, _ = parts[0]
        return from_numpy(assemble_slice(
            entry, path, off, tuple(o + n for o, n in zip(off, shp)),
            validate=validate, cache=cache), entry["dtype"])
    out = torch.zeros(tuple(shape), dtype=out.dtype)
    _, parts = boxes(out, layout)
    for off, shp, view in parts:
        piece = assemble_slice(entry, path, off,
                               tuple(o + n for o, n in zip(off, shp)),
                               validate=validate, cache=cache)
        view.copy_(from_numpy(piece, entry["dtype"]))
    return out


def checkpoint_topology(path, validate=True):
    """What topology a checkpoint was saved under: the sentinel's
    ``topology`` block (process/device counts, meshes) plus each
    tensor's recorded placement descriptor. Launchers and tools use
    this to report same-topology vs cross-mesh resumes; the loader
    itself reshards to the target layout regardless."""
    sentinel = validate_checkpoint(path) if validate else {}
    placements = {}
    for name, entry in _read_metas(path).items():
        if entry.get("kind") == "tensor":
            placements[name] = entry.get("placement")
    return {"world_size": sentinel.get("world_size"),
            "topology": sentinel.get("topology"),
            "placements": placements}
