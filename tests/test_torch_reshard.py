"""Resharding on load (``distributed.checkpoint.reshard``) on port ranks:
the ten cases of ``tests/test_reshard.py``.

The JAX cases shard one array over a mesh of devices; here each of 1, 2
or 4 gloo ranks (``torch_dist_pool.RankPool``, running
``torch_ckpt_cases``) holds its part of the tensor over the fleet's
``model`` group, split on a dim (``metadata.Layout``). What is held:
the placements and topology the port records (in the JAX module's
shape, read by the JAX ``checkpoint_topology``), that ``assemble_slice``
opens only the shard files that overlap a box, the resize in both
directions, a change of split dim with the dp replicas dividing the
writes, bf16 bit for bit, the merge of every rank's metadata, and the
refusal of a missing rank's shards and of a corrupt shard. Every value
is compared bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.checkpoint import reshard as jreshard

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.checkpoint import reshard
from paddle_tpu_torch.distributed.checkpoint.validation import _read_metas

from torch_dist_pool import RankPool

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        # a pool killed by a failed call is started again
        if n not in made or not made[n].alive():
            made[n] = RankPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


def _w(seed, shape=(8, 16)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _save(pools, n, tensors, path, hybrid=None, values=None):
    return pools(n).run("torch_ckpt_cases:save_split", tensors, str(path),
                        hybrid or {"mp_degree": n}, values)


def _load(pools, n, shapes, path, hybrid=None):
    return pools(n).run("torch_ckpt_cases:load_split", shapes, str(path),
                        hybrid or {"mp_degree": n})


def _expect(full, dim, res):
    """Each rank's part of ``full`` split on ``dim`` over its model
    group."""
    n = len({r["mp_rank"] for r in res})
    return [full if dim is None else np.split(full, n, dim)[r["mp_rank"]]
            for r in res]


# ---- topology metadata --------------------------------------------------------

def test_placement_and_topology_recorded(pools, tmp_path):
    w = _w(0)
    path = tmp_path / "step_1"
    _save(pools, 4, {"w": (w, "float32", 0)}, path, values={"step": 7})
    for topo in (ckpt.checkpoint_topology(str(path)),
                 jreshard.checkpoint_topology(str(path))):
        assert topo["world_size"] == 4
        assert topo["topology"]["process_count"] == 4
        assert topo["topology"]["device_count"] == 4
        axes = ["data", "sharding", "pipe", "sep", "model", "expert"]
        assert [[1, 1, 1, 1, 4, 1], axes] in topo["topology"]["meshes"]
        assert topo["placements"]["w"] == {
            "mesh_shape": [1, 1, 1, 1, 4, 1], "mesh_axes": axes,
            "spec": ["model", None]}
    sentinel = json.loads((path / "COMMITTED").read_bytes())
    assert sentinel["topology"]["meshes"] == [[[1, 1, 1, 1, 4, 1], axes]]


def test_placement_none_for_single_device(pools, tmp_path):
    _save(pools, 1, {"w": (np.ones(4, np.float32), "float32", None)},
          tmp_path / "step_1")
    topo = jreshard.checkpoint_topology(str(tmp_path / "step_1"))
    assert topo["placements"]["w"] is None
    assert topo["world_size"] == 1


# ---- slice assembly reads only what it needs --------------------------------

def test_assemble_slice_exact_and_minimal(pools, tmp_path, monkeypatch):
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    _save(pools, 4, {"w": (w, "float32", 0)}, tmp_path / "ck")
    entry = _read_metas(str(tmp_path / "ck"))["w"]
    assert len(entry["shards"]) == 4   # 2 rows per shard
    reads = []
    real = reshard._read_file

    def spy(path):
        reads.append(os.path.basename(path))
        return real(path)

    monkeypatch.setattr(reshard, "_read_file", spy)
    # rows 0..3 live in the first two shards only
    out = reshard.assemble_slice(entry, str(tmp_path / "ck"),
                                 (0, 0), (4, 8))
    np.testing.assert_array_equal(out, w[0:4])
    assert len(reads) == 2, reads
    # a single row touches exactly one shard
    reads.clear()
    out = reshard.assemble_slice(entry, str(tmp_path / "ck"),
                                 (6, 2), (7, 5))
    np.testing.assert_array_equal(out, w[6:7, 2:5])
    assert len(reads) == 1, reads


def test_assemble_slice_detects_missing_coverage(pools, tmp_path):
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    _save(pools, 4, {"w": (w, "float32", 0)}, tmp_path / "ck")
    entry = _read_metas(str(tmp_path / "ck"))["w"]
    entry = dict(entry, shards=entry["shards"][:-1])  # lose one rank
    with pytest.raises(ckpt.CheckpointCorruptError, match="cover only"):
        reshard.assemble_slice(entry, str(tmp_path / "ck"), (0, 0), (8, 8))


# ---- resize, both directions -------------------------------------------------

@pytest.mark.parametrize("save_n,load_n", [(4, 2), (2, 4), (1, 2), (4, 1)])
def test_reshard_resize_both_directions(pools, tmp_path, save_n, load_n):
    w = _w(1)
    _save(pools, save_n, {"w": (w, "float32", 0)}, tmp_path / "ck")
    res = _load(pools, load_n, {"w": ((8, 16), "float32", 0)},
                tmp_path / "ck")
    for r, want in zip(res, _expect(w, 0, res)):
        np.testing.assert_array_equal(r["parts"]["w"], want)
    # every rank of a load at another degree reshards its tensor
    assert [r["resharded"] for r in res] == [1] * load_n


def test_reshard_dp_mp_to_mp_only(pools, tmp_path):
    """(2, 2) dp x mp save, split over mp on dim 1 and replicated over dp
    (the two dp replicas each write half of their part) -> a (2,)
    mp-only load split on dim 0: the shrink-on-preemption shape."""
    w = _w(2, (8, 8))
    files = _save(pools, 4, {"w": (w, "float32", 1)}, tmp_path / "ck",
                  {"dp_degree": 2, "mp_degree": 2})
    assert all(len(f) == 1 for f in files), files
    entry = _read_metas(str(tmp_path / "ck"))["w"]
    assert sorted(tuple(s["local_shape"]) for s in entry["shards"]) == \
        [(4, 4)] * 4
    res = _load(pools, 2, {"w": ((8, 8), "float32", 0)}, tmp_path / "ck")
    for r, want in zip(res, _expect(w, 0, res)):
        np.testing.assert_array_equal(r["parts"]["w"], want)


def test_reshard_bf16(pools, tmp_path):
    import ml_dtypes
    w = _w(3, (8, 8)).astype(ml_dtypes.bfloat16).view(np.uint16)
    _save(pools, 4, {"w": (w, "bfloat16", 0)}, tmp_path / "ck")
    res = _load(pools, 2, {"w": ((8, 8), "bfloat16", 0)}, tmp_path / "ck")
    for r, want in zip(res, _expect(w, 0, res)):
        np.testing.assert_array_equal(r["parts"]["w"], want)


# ---- cross-rank metadata merge -------------------------------------------------

def test_cross_rank_meta_merge(pools, tmp_path):
    """A load sees the UNION of every rank's shards: the tensor entries
    of each ``meta.<rank>.json`` merge."""
    w = _w(4, (8, 8))
    path = tmp_path / "ck"
    _save(pools, 4, {"w": (w, "float32", 0)}, path)
    metas = [json.loads((path / f"meta.{r}.json").read_bytes())
             for r in range(4)]
    assert [len(m["w"]["shards"]) for m in metas] == [1] * 4
    merged = _read_metas(str(path))
    assert len(merged["w"]["shards"]) == 4
    # the whole tensor in one process, and a split on the other dim
    target = {"w": torch.zeros(8, 8)}
    ckpt.load_state_dict(target, str(path))
    np.testing.assert_array_equal(target["w"].numpy(), w)
    res = _load(pools, 2, {"w": ((8, 8), "float32", 1)}, path)
    for r, want in zip(res, _expect(w, 1, res)):
        np.testing.assert_array_equal(r["parts"]["w"], want)


def test_missing_rank_shard_refused(pools, tmp_path):
    """Some ranks committed, others not: a checkpoint whose metadata names
    a shard file that never landed is refused by the whole and the
    resharded load and by deep validation, never zero-filled."""
    w = _w(5, (8, 8))
    path = tmp_path / "ck"
    _save(pools, 4, {"w": (w, "float32", 0)}, path)
    os.remove(path / "w.r3.s0.npy")
    with pytest.raises(ckpt.CheckpointCorruptError, match="missing"):
        ckpt.load_state_dict({"w": torch.zeros(8, 8)}, str(path))
    with pytest.raises(AssertionError, match="CheckpointCorruptError"):
        _load(pools, 2, {"w": ((8, 8), "float32", 0)}, path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.validate_checkpoint(str(path), deep=True)


def test_reshard_corrupt_shard_refused(pools, tmp_path):
    w = _w(6, (8, 8))
    path = tmp_path / "ck"
    _save(pools, 4, {"w": (w, "float32", 0)}, path)
    shard = path / "w.r0.s0.npy"
    blob = bytearray(shard.read_bytes())
    blob[-1] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises(AssertionError, match="sha256"):
        _load(pools, 2, {"w": ((8, 8), "float32", 0)}, path)
