"""The port's crash-safe checkpoints: the one-process cases of
tests/test_checkpoint_fault.py (commit, refusal of torn and corrupt
checkpoints, overwrite, discovery, retention, the ``.old`` backup), the
``save``/``load`` pickle, and the format shared with the JAX package: a
checkpoint either package writes validates and loads in the other, bit
for bit, bf16 included.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt

import paddle_tpu_torch
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.checkpoint import validation


def _sd(value, shape=(4, 4)):
    return {"w": torch.full(shape, float(value)), "step": int(value)}


def _target(shape=(4, 4)):
    return {"w": torch.zeros(shape), "step": 0}


def _full(v):
    return torch.full((4, 4), float(v))


# ---- commit protocol basics -------------------------------------------------

def test_save_commits_sentinel_and_cleans_staging(tmp_path):
    path = tmp_path / "ck"
    ckpt.save_state_dict(_sd(1), str(path))
    assert ckpt.is_committed(str(path))
    sentinel = json.loads((path / "COMMITTED").read_bytes())
    assert sentinel["world_size"] == 1
    assert "meta.0.json" in sentinel["metas"]
    assert [n for n in os.listdir(tmp_path) if ".tmp-" in n] == []
    assert not any(n.endswith(".part") for n in os.listdir(path))
    target = _target()
    ckpt.load_state_dict(target, str(path))
    assert torch.equal(target["w"], _full(1))
    assert ckpt.load_values(str(path)) == {"step": 1}


def test_load_refuses_uncommitted_dir(tmp_path):
    path = tmp_path / "ck"
    ckpt.save_state_dict(_sd(1), str(path))
    os.remove(path / "COMMITTED")
    with pytest.raises(ckpt.CheckpointNotCommittedError, match="COMMITTED"):
        ckpt.load_state_dict(_target(), str(path))
    target = _target()
    ckpt.load_state_dict(target, str(path), validate=False)
    assert torch.equal(target["w"], _full(1))


def test_load_refuses_corrupt_shard(tmp_path):
    path = tmp_path / "ck"
    ckpt.save_state_dict(_sd(1), str(path))
    shard = next(p for p in path.iterdir() if p.name.endswith(".npy"))
    blob = bytearray(shard.read_bytes())
    blob[-1] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises(ckpt.CheckpointCorruptError, match="sha256"):
        ckpt.load_state_dict(_target(), str(path))
    with pytest.raises(ckpt.CheckpointCorruptError, match="sha256"):
        ckpt.read_state_dict(str(path))


def test_validate_refuses_tampered_metadata(tmp_path):
    path = tmp_path / "ck"
    ckpt.save_state_dict(_sd(1), str(path))
    meta = path / "meta.0.json"
    meta.write_bytes(meta.read_bytes() + b" ")
    with pytest.raises(ckpt.CheckpointCorruptError,
                       match="metadata checksum"):
        ckpt.validate_checkpoint(str(path))


def test_overwrite_existing_checkpoint(tmp_path):
    path = tmp_path / "ck"
    ckpt.save_state_dict(_sd(1), str(path))
    ckpt.save_state_dict(_sd(2), str(path))
    assert ckpt.is_committed(str(path))
    target = _target()
    ckpt.load_state_dict(target, str(path))
    assert torch.equal(target["w"], _full(2))
    assert not os.path.isdir(str(path) + ".old")


# ---- discovery + retention --------------------------------------------------

def test_latest_valid_checkpoint_skips_torn(tmp_path):
    ckpt.save_state_dict(_sd(1), str(tmp_path / "step_1"))
    ckpt.save_state_dict(_sd(3), str(tmp_path / "step_3"))
    ckpt.save_state_dict(_sd(5), str(tmp_path / "step_5"))
    os.remove(tmp_path / "step_5" / "COMMITTED")
    os.makedirs(tmp_path / "step_4.tmp-dead")
    best = ckpt.latest_valid_checkpoint(str(tmp_path))
    assert best is not None and os.path.basename(best) == "step_3"
    shard = next(p for p in (tmp_path / "step_3").iterdir()
                 if p.name.endswith(".npy"))
    blob = bytearray(shard.read_bytes())
    blob[-1] ^= 0xFF
    shard.write_bytes(bytes(blob))
    best = ckpt.latest_valid_checkpoint(str(tmp_path), deep=True)
    assert best is not None and os.path.basename(best) == "step_1"
    assert ckpt.latest_valid_checkpoint(str(tmp_path / "missing")) is None


def test_retention_gc_keep_last_n(tmp_path):
    for s in range(1, 6):
        ckpt.save_state_dict(_sd(s), str(tmp_path / f"step_{s}"),
                             keep_last_n=2)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    os.makedirs(tmp_path / "step_3.tmp-dead")
    os.makedirs(tmp_path / "step_2")
    os.makedirs(tmp_path / "step_9.tmp-live")
    removed = ckpt.gc_checkpoints(str(tmp_path), 2)
    assert sorted(os.path.basename(r) for r in removed) == \
        ["step_2", "step_3.tmp-dead"]
    assert sorted(os.listdir(tmp_path)) == \
        ["step_4", "step_5", "step_9.tmp-live"]


def test_gc_spares_active_staging_dirs(tmp_path):
    ckpt.save_state_dict(_sd(6), str(tmp_path / "step_6"))
    live = str(tmp_path / "step_5.tmp-live")
    os.makedirs(live)
    validation._active_stages.add(live)
    try:
        assert ckpt.gc_checkpoints(str(tmp_path), 2) == []
        assert os.path.isdir(live)
    finally:
        validation._active_stages.discard(live)
    assert ckpt.gc_checkpoints(str(tmp_path), 2) == [live]


def test_gc_never_deletes_newest_valid_during_staged_save(tmp_path):
    ckpt.save_state_dict(_sd(10), str(tmp_path / "step_10"))
    ckpt.save_state_dict(_sd(20), str(tmp_path / "step_20"))
    meta = tmp_path / "step_20" / "meta.0.json"
    meta.write_bytes(meta.read_bytes() + b" ")
    os.makedirs(tmp_path / "step_30.tmp-inflight")
    removed = ckpt.gc_checkpoints(str(tmp_path), 1)
    assert str(tmp_path / "step_10") not in removed
    assert os.path.isdir(tmp_path / "step_10")
    assert os.path.isdir(tmp_path / "step_30.tmp-inflight")
    best = ckpt.latest_valid_checkpoint(str(tmp_path))
    assert best is not None and os.path.basename(best) == "step_10"
    ckpt.save_state_dict(_sd(30), str(tmp_path / "step_30"), keep_last_n=1)
    assert not os.path.isdir(tmp_path / "step_10")
    assert ckpt.latest_valid_checkpoint(str(tmp_path)) == \
        str(tmp_path / "step_30")


def test_gc_and_discovery_skip_sentineled_dir_missing_a_shard(tmp_path):
    ckpt.save_state_dict(_sd(10), str(tmp_path / "step_10"))
    ckpt.save_state_dict(_sd(20), str(tmp_path / "step_20"))
    shard = next(p for p in (tmp_path / "step_20").iterdir()
                 if p.name.endswith(".npy"))
    os.remove(shard)
    assert not ckpt.shards_intact(str(tmp_path / "step_20"))
    assert ckpt.shards_intact(str(tmp_path / "step_10"))
    best = ckpt.latest_valid_checkpoint(str(tmp_path))
    assert best is not None and os.path.basename(best) == "step_10"
    removed = ckpt.gc_checkpoints(str(tmp_path), 1)
    assert str(tmp_path / "step_10") not in removed
    with pytest.raises(ckpt.CheckpointCorruptError, match="missing"):
        ckpt.load_state_dict(_target(), str(tmp_path / "step_20"))


def test_gc_spares_old_backup_of_corrupt_plain_dir(tmp_path):
    path = tmp_path / "step_5"
    ckpt.save_state_dict(_sd(6), str(path))
    meta = path / "meta.0.json"
    meta.write_bytes(meta.read_bytes() + b" ")
    ckpt.save_state_dict(_sd(5), str(tmp_path / "prev"))
    os.rename(tmp_path / "prev", str(path) + ".old")
    ckpt.save_state_dict(_sd(7), str(tmp_path / "step_7"))
    removed = ckpt.gc_checkpoints(str(tmp_path), 2)
    assert str(path) + ".old" not in removed
    assert os.path.isdir(str(path) + ".old")


def test_crashed_overwrite_recovers_from_old_backup(tmp_path):
    path = tmp_path / "step_5"
    ckpt.save_state_dict(_sd(5), str(path))
    os.rename(path, str(path) + ".old")
    os.makedirs(str(path) + ".tmp-dead")
    best = ckpt.latest_valid_checkpoint(str(tmp_path))
    assert best == str(path) + ".old"
    target = _target()
    ckpt.load_state_dict(target, best)
    assert torch.equal(target["w"], _full(5))
    ckpt.save_state_dict(_sd(6), str(path), keep_last_n=2)
    assert sorted(os.listdir(tmp_path)) == ["step_5"]


# ---- the format both packages write -----------------------------------------

def _values():
    rng = np.random.RandomState(0)
    return {"f32": rng.randn(3, 5).astype(np.float32),
            "bf16": rng.randn(4, 2).astype(np.float32),
            "i32": rng.randint(-9, 9, (6,)).astype(np.int32),
            "scalar": np.float32(0.25)}


def _port_state():
    v = _values()
    return {"model": {"layers.0.w": torch.from_numpy(v["f32"]),
                      "emb": torch.from_numpy(v["bf16"]).to(torch.bfloat16)},
            "ids": torch.from_numpy(v["i32"]),
            "optimizer": {"param_0_beta1_pow": torch.tensor(v["scalar"]),
                          "LR_Scheduler": {"last_epoch": 3,
                                           "last_lr": 0.5},
                          "@step": 3},
            "epoch": 1}


def _jax_state():
    v = _values()
    return {"model": {"layers.0.w": paddle.to_tensor(v["f32"]),
                      "emb": paddle.to_tensor(jnp.asarray(v["bf16"],
                                                          jnp.bfloat16))},
            "ids": paddle.to_tensor(v["i32"]),
            "optimizer": {"param_0_beta1_pow": paddle.to_tensor(
                jnp.asarray(v["scalar"])),
                "LR_Scheduler": {"last_epoch": 3, "last_lr": 0.5},
                "@step": 3},
            "epoch": 1}


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy()
    a = np.asarray(t if not hasattr(t, "numpy") else t.numpy())
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _check_read(read, want):
    assert set(read) == {"model.layers.0.w", "model.emb", "ids",
                         "optimizer.param_0_beta1_pow",
                         "optimizer.LR_Scheduler.last_epoch",
                         "optimizer.LR_Scheduler.last_lr",
                         "optimizer.@step", "epoch"}
    for key, ref in (("model.layers.0.w", want["model"]["layers.0.w"]),
                     ("model.emb", want["model"]["emb"]),
                     ("ids", want["ids"]),
                     ("optimizer.param_0_beta1_pow",
                      want["optimizer"]["param_0_beta1_pow"])):
        np.testing.assert_array_equal(_bits(read[key]), _bits(ref))


def test_jax_checkpoint_validates_and_loads_in_the_port(tmp_path):
    path = str(tmp_path / "step_1")
    jckpt.save_state_dict(_jax_state(), path)
    ckpt.validate_checkpoint(path, deep=True)
    assert ckpt.latest_valid_checkpoint(str(tmp_path)) == path
    want = _port_state()
    target = {"model": {"layers.0.w": torch.zeros(3, 5),
                        "emb": torch.zeros(4, 2, dtype=torch.bfloat16)},
              "ids": torch.zeros(6, dtype=torch.int32)}
    ckpt.load_state_dict(target, path)
    for k in ("layers.0.w", "emb"):
        assert target["model"][k].dtype == want["model"][k].dtype
        assert torch.equal(target["model"][k], want["model"][k])
    assert torch.equal(target["ids"], want["ids"])
    read = ckpt.read_state_dict(path)
    assert read["model.emb"].dtype == torch.bfloat16
    _check_read(read, want)
    assert ckpt.load_values(path) == {
        "optimizer": {"LR_Scheduler": {"last_epoch": 3, "last_lr": 0.5},
                      "@step": 3}, "epoch": 1}


def test_port_checkpoint_validates_and_loads_in_jax(tmp_path):
    path = str(tmp_path / "step_1")
    ckpt.save_state_dict(_port_state(), path)
    jckpt.validate_checkpoint(path, deep=True)
    want = _jax_state()
    target = {"model": {"layers.0.w": paddle.to_tensor(np.zeros((3, 5),
                                                                np.float32)),
                        "emb": paddle.to_tensor(jnp.zeros((4, 2),
                                                          jnp.bfloat16))},
              "ids": paddle.to_tensor(np.zeros(6, np.int32))}
    jckpt.load_state_dict(target, path)
    for k in ("layers.0.w", "emb"):
        np.testing.assert_array_equal(_bits(target["model"][k]),
                                      _bits(want["model"][k]))
    np.testing.assert_array_equal(_bits(target["ids"]), _bits(want["ids"]))
    _check_read(jckpt.read_state_dict(path), want)
    assert jckpt.load_values(path)["optimizer"]["@step"] == 3


def test_both_packages_write_the_same_metadata(tmp_path):
    """Equal values give equal shard bytes, so the metadata files (shard
    names, shapes, dtype names, checksums, sizes) are equal too."""
    ckpt.save_state_dict(_port_state(), str(tmp_path / "port"))
    jckpt.save_state_dict(_jax_state(), str(tmp_path / "jax"))
    port = json.loads((tmp_path / "port" / "meta.0.json").read_bytes())
    jax_ = json.loads((tmp_path / "jax" / "meta.0.json").read_bytes())
    assert port == jax_
    assert port["model.emb"]["dtype"] == "bfloat16"


def test_a_tiled_tensor_is_assembled_and_a_missing_tile_refused(tmp_path):
    """A multi-rank save lists several shards of a tensor; the port
    assembles them, and refuses a tensor they do not cover."""
    path = tmp_path / "ck"
    ckpt.save_state_dict({"w": torch.arange(8.0).reshape(4, 2)}, str(path))
    meta_path = path / "meta.0.json"
    meta = json.loads(meta_path.read_bytes())
    shard = meta["w"]["shards"][0]
    full = np.load(path / shard["file"])
    for i, rows in enumerate((slice(0, 1), slice(1, 4))):
        name = f"w.r{i}.s1.npy"
        np.save(path / name, full[rows])
    meta["w"]["shards"] = [
        {"offset": [0, 0], "local_shape": [1, 2], "file": "w.r0.s1.npy"},
        {"offset": [1, 0], "local_shape": [3, 2], "file": "w.r1.s1.npy"}]
    meta_path.write_text(json.dumps(meta))
    target = {"w": torch.zeros(4, 2)}
    ckpt.load_state_dict(target, str(path), validate=False)
    assert torch.equal(target["w"], torch.arange(8.0).reshape(4, 2))
    meta["w"]["shards"] = meta["w"]["shards"][1:]
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ckpt.CheckpointCorruptError, match="cover only"):
        ckpt.load_state_dict(target, str(path), validate=False)


# ---- save / load ------------------------------------------------------------

def test_save_load_round_trips_dtypes_and_structure(tmp_path):
    obj = {"w": torch.randn(3, 2, generator=torch.Generator().manual_seed(0)
                            ).to(torch.bfloat16),
           "ids": torch.arange(5, dtype=torch.int64),
           "fp8": torch.tensor([0.5, -2.0]).to(torch.float8_e4m3fn),
           "nested": {"lr": {"last_epoch": 4}, "list": [torch.ones(2), 3]},
           "@step": 7}
    path = str(tmp_path / "sub" / "m.pdparams")
    paddle_tpu_torch.save(obj, path)
    back = paddle_tpu_torch.load(path, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             obj["w"])
    assert back["fp8"].dtype == torch.float8_e4m3fn
    assert torch.equal(back["fp8"].view(torch.uint8),
                       obj["fp8"].view(torch.uint8))
    assert torch.equal(back["ids"], obj["ids"])
    assert back["nested"]["lr"] == {"last_epoch": 4}
    assert torch.equal(back["nested"]["list"][0], torch.ones(2))
    assert back["nested"]["list"][1] == 3 and back["@step"] == 7
    as_np = paddle_tpu_torch.load(path, return_numpy=True)
    assert as_np["ids"].dtype == np.int64
    np.testing.assert_array_equal(as_np["w"], obj["w"].float().numpy())


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    """``load`` with no device puts tensors on ``cuda``, as every entry
    point of the port; with no GPU it raises rather than land on the CPU.
    ``return_numpy`` needs no device."""
    path = str(tmp_path / "m.pdparams")
    paddle_tpu_torch.save({"w": torch.ones(2)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.load(path)
    np.testing.assert_array_equal(
        paddle_tpu_torch.load(path, return_numpy=True)["w"], np.ones(2))
