"""Multi-rank checkpoints of the port (``distributed.checkpoint``,
``hapi.Model.save_checkpoint``/``load_checkpoint``) on 1, 2 and 4 gloo
ranks, against the JAX package.

- The format both ways: two port ranks' checkpoint of split f32 and bf16
  tensors loads in the JAX package bit for bit; a JAX checkpoint saved
  from a 4-device CPU mesh loads into port ranks at mp 2 and into one
  port process bit for bit.
- The commit protocol on real ranks (``tests/test_checkpoint_fault.py``
  :251, :335, :451-514): a crashed attempt's staging files never mix
  into a commit; a rank whose ack never lands, or a rank that never
  calls save, leaves the checkpoint uncommitted within
  ``barrier_timeout``; async failures re-raise on the wait and on the
  next save; an async save commits atomically and holds the state as it
  was at the call while the optimizer steps on.
- Models across degrees (the port of ``tests/test_dist_checkpoint.py:99``):
  tiny Llama saved at mp 2 resumes at mp 1, mp 4 and dp 2; ZeRO stage 2
  and 3 over sharding 2 resume at mp 1 and mp 2; one process's save
  resumes at mp 2. The losses before and after the resume equal the JAX
  single-device AdamW run on the same weights within ``rtol`` 1e-5 at
  the first step and 1e-4 after (``tests/test_torch_tensor_parallel.py``'s
  limits: the sums' order moves a step's loss by some 1e-7, and AdamW's
  normalised updates carry it on).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.checkpoint import save_load
from paddle_tpu_torch.optimizer import AdamW

from test_torch_tensor_parallel import check_losses, jax_train, replica_mean
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


def _bf16(a):
    import ml_dtypes
    return a.astype(ml_dtypes.bfloat16)


# ---- the format both ways ---------------------------------------------------------

def test_two_port_ranks_checkpoint_loads_in_jax_bit_for_bit(pools,
                                                           tmp_path):
    rng = np.random.RandomState(0)
    w0 = rng.randn(8, 6).astype(np.float32)
    w1 = rng.randn(4, 10).astype(np.float32)
    b = _bf16(rng.randn(6, 8).astype(np.float32))
    r = rng.randn(5).astype(np.float32)
    tensors = {"w0": (w0, "float32", 0), "w1": (w1, "float32", 1),
               "b": (b.view(np.uint16), "bfloat16", 1),
               "r": (r, "float32", None)}
    path = str(tmp_path / "ck")
    pools(2).run("torch_ckpt_cases:save_split", tensors, path,
                 {"mp_degree": 2}, {"epoch": 3})
    jckpt.validate_checkpoint(path, deep=True)
    target = {"w0": paddle.to_tensor(np.zeros_like(w0)),
              "w1": paddle.to_tensor(np.zeros_like(w1)),
              "b": paddle.to_tensor(np.zeros((6, 8), np.float32))
              .astype("bfloat16"),
              "r": paddle.to_tensor(np.zeros_like(r))}
    jckpt.load_state_dict(target, path)
    for k, want in (("w0", w0), ("w1", w1), ("r", r)):
        np.testing.assert_array_equal(target[k].numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(target["b"].jax()).view(np.uint16), b.view(np.uint16))
    assert jckpt.load_values(path) == {"epoch": 3}


def test_jax_checkpoint_from_a_4_device_mesh_loads_into_port_ranks(
        pools, tmp_path):
    rng = np.random.RandomState(1)
    w_row = rng.randn(8, 16).astype(np.float32)
    w_col = rng.randn(8, 16).astype(np.float32)
    b_col = _bf16(rng.randn(4, 8).astype(np.float32))
    mesh = Mesh(np.array(jax.devices()[:4]), ("mp",))

    def sharded(a, spec):
        return paddle.Tensor(jax.device_put(jnp.asarray(a),
                                            NamedSharding(mesh, spec)))

    path = str(tmp_path / "jax")
    jckpt.save_state_dict({"w_row": sharded(w_row, P("mp")),
                           "w_col": sharded(w_col, P(None, "mp")),
                           "b_col": sharded(b_col, P(None, "mp")),
                           "step": 5}, path)
    shapes = {"w_row": ((8, 16), "float32", 0),
              "w_col": ((8, 16), "float32", 1),
              "b_col": ((4, 8), "bfloat16", 1)}
    got = pools(2).run("torch_ckpt_cases:load_split", shapes, path,
                       {"mp_degree": 2})
    for res in got:
        r = res["mp_rank"]
        np.testing.assert_array_equal(res["parts"]["w_row"],
                                      np.split(w_row, 2, 0)[r])
        np.testing.assert_array_equal(res["parts"]["w_col"],
                                      np.split(w_col, 2, 1)[r])
        np.testing.assert_array_equal(
            res["parts"]["b_col"], np.split(b_col.view(np.uint16), 2, 1)[r])
        assert res["values"] == {"step": 5}
    # one port process: the whole tensors
    target = {"w_row": torch.zeros(8, 16), "w_col": torch.zeros(8, 16),
              "b_col": torch.zeros(4, 8, dtype=torch.bfloat16)}
    ckpt.load_state_dict(target, path)
    np.testing.assert_array_equal(target["w_row"].numpy(), w_row)
    np.testing.assert_array_equal(target["w_col"].numpy(), w_col)
    np.testing.assert_array_equal(
        target["b_col"].view(torch.uint16).numpy(), b_col.view(np.uint16))


# ---- the commit protocol on real ranks ------------------------------------------

def test_multirank_stale_staging_cannot_mix_attempts(pools, tmp_path):
    """A crashed 2-rank attempt left rank 1's shard, metadata and ack in
    the shared staging dir; the relaunched save of the same step must not
    be satisfied by them: the coordinator wipes the dir and stamps a
    fresh ATTEMPT token that each rank echoes."""
    final = tmp_path / "step_2"
    stage = str(final) + ".tmp-shared"
    os.makedirs(stage)
    stale = save_load._np_bytes(np.full((4, 4), -99.0, np.float32))
    with open(os.path.join(stage, "stale.r1.s0.npy"), "wb") as f:
        f.write(stale)
    meta = {"stale": {"kind": "tensor", "global_shape": [4, 4],
                      "dtype": "float32",
                      "shards": [{"offset": [0, 0], "local_shape": [4, 4],
                                  "file": "stale.r1.s0.npy"}]}}
    with open(os.path.join(stage, "meta.1.json"), "w") as f:
        json.dump(meta, f)
    for name in ("ATTEMPT", "ack.1"):
        with open(os.path.join(stage, name), "w") as f:
            f.write("staletoken")
    pools(2).run("torch_ckpt_cases:stale_staging_save", str(final), 2)
    assert ckpt.is_committed(str(final))
    assert ckpt.validate_checkpoint(str(final))["world_size"] == 2
    assert "stale.r1.s0.npy" not in os.listdir(final)
    got = ckpt.read_state_dict(str(final))
    assert "stale" not in got and got["step"] == 2
    assert torch.equal(got["w"], torch.full((4, 4), 2.0))


def test_partial_shard_write_never_commits(pools, tmp_path):
    """Rank 1 stages its shard but its ack never lands: the coordinator's
    barrier times out, the step stays an uncommitted staging dir, and
    discovery resumes from the prior good step."""
    ckpt.save_state_dict({"w": torch.ones(4, 4)}, str(tmp_path / "step_1"))
    errs = pools(2).run("torch_ckpt_cases:ack_never_lands",
                        str(tmp_path / "step_2"), 2.0)
    assert "barrier timed out" in errs[0] and "ranks [1]" in errs[0]
    assert errs[1].startswith("RuntimeError") and \
        "ack never lands" in errs[1]
    assert not os.path.exists(tmp_path / "step_2")
    assert os.path.isdir(str(tmp_path / "step_2") + ".tmp-shared")
    best = ckpt.latest_valid_checkpoint(str(tmp_path))
    assert os.path.basename(best) == "step_1"


def test_a_rank_that_never_saves_times_out_uncommitted(pools, tmp_path):
    """The barrier is on the filesystem, not a collective: rank 0 alone
    in save fails within ``barrier_timeout`` and commits nothing."""
    err, seconds = pools(2).run("torch_ckpt_cases:only_rank0_saves",
                                str(tmp_path / "step_1"), 2.0)[0]
    assert "barrier timed out after 2.0s" in err and "ranks [1]" in err
    assert 2.0 <= seconds < 10.0
    assert ckpt.latest_valid_checkpoint(str(tmp_path)) is None


def test_async_save_on_two_ranks_commits_atomically(pools, tmp_path):
    w = np.random.RandomState(2).randn(8, 4).astype(np.float32)
    path = str(tmp_path / "step_8")
    pools(2).run("torch_ckpt_cases:save_split", {"w": (w, "float32", 0)},
                 path, {"mp_degree": 2}, None, True)
    assert ckpt.is_committed(path)
    assert ckpt.latest_valid_checkpoint(str(tmp_path)) == path
    np.testing.assert_array_equal(ckpt.read_state_dict(path)["w"].numpy(),
                                  w)


def _sd(v):
    return {"w": torch.full((4, 4), float(v)), "step": v}


def test_async_save_failure_reraises_on_wait(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    ckpt.save_state_dict(_sd(1), str(blocker / "ck"), async_save=True)
    with pytest.raises(OSError):
        ckpt.wait_async_save()
    ckpt.wait_async_save()  # the error is consumed


def test_async_save_failure_surfaces_on_next_save(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    ckpt.save_state_dict(_sd(1), str(blocker / "ck"), async_save=True)
    for th in list(save_load._async_threads):
        th.join(60)
        assert not th.is_alive()
    with pytest.raises(OSError):
        ckpt.save_state_dict(_sd(2), str(tmp_path / "ok"))
    ckpt.save_state_dict(_sd(2), str(tmp_path / "ok"))
    assert ckpt.is_committed(str(tmp_path / "ok"))
    ckpt.wait_async_save()


def test_async_save_holds_the_state_at_the_call(tmp_path, monkeypatch):
    """The snapshot copies: AdamW steps the parameters, moments and
    master weights in place while the writer runs, and the committed
    files hold the state as it was when save_state_dict returned."""
    torch.manual_seed(0)
    net = torch.nn.Linear(8, 8).to(torch.bfloat16)
    opt = AdamW(learning_rate=0.1, parameters=net.parameters())
    x = torch.randn(4, 8, dtype=torch.bfloat16)

    def step():
        net(x).float().square().mean().backward()
        opt.step()
        opt.clear_grad()
    step()
    state = {"model": net.state_dict(), "optimizer": opt.state_dict()}
    want = {k: v.clone() for k, v in save_load._flat(state).items()
            if isinstance(v, torch.Tensor)}
    real, started = save_load._atomic_write, threading.Event()

    def slow(path, data):
        started.set()
        time.sleep(0.05)
        return real(path, data)
    monkeypatch.setattr(save_load, "_atomic_write", slow)
    path = str(tmp_path / "step_1")
    ckpt.save_state_dict(state, path, async_save=True)
    assert started.wait(10)
    alive = any(th.is_alive() for th in save_load._async_threads)
    for _ in range(3):
        step()
    ckpt.wait_async_save()
    assert alive, "the writer finished before the optimizer stepped"
    got = ckpt.read_state_dict(path)
    moved = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        moved += not torch.equal(save_load._flat(
            {"model": net.state_dict(),
             "optimizer": opt.state_dict()})[k], v)
    assert moved >= 4     # weights, masters and moments moved on


# ---- fleet.utils.fs -------------------------------------------------------------------

def test_fleet_utils_fs_matches_the_jax_local_fs(tmp_path):
    """``fleet.utils.LocalFS`` does what the JAX package's does on the
    same operations (listings, moves, reads, the two errors), and
    ``HDFSClient`` refuses to be built."""
    from paddle_tpu.distributed.fleet.utils import fs as jfs
    from paddle_tpu_torch.distributed.fleet import utils

    def drive(fs, root):
        out = []
        fs.mkdirs(f"{root}/a/b")
        fs.touch(f"{root}/a/f")
        out.append(fs.ls_dir(f"{root}/a"))
        with open(f"{root}/a/f", "wb") as f:
            f.write(b"payload")
        out.append(fs.cat(f"{root}/a/f"))
        fs.mv(f"{root}/a/f", f"{root}/g")
        for call in (lambda: fs.mv(f"{root}/missing", f"{root}/x"),
                     lambda: fs.touch(f"{root}/g", exist_ok=False)):
            try:
                call()
            except Exception as e:  # noqa: BLE001 — the type is compared
                out.append(type(e).__name__)
        fs.delete(f"{root}/a")
        out.append((fs.list_dirs(root), fs.is_file(f"{root}/g"),
                    fs.need_upload_download()))
        return out

    assert drive(utils.LocalFS(), str(tmp_path / "port")) == \
        drive(jfs.LocalFS(), str(tmp_path / "jax"))
    assert utils.FSFileExistsError.__name__ == "FSFileExistsError"
    with pytest.raises(RuntimeError, match="HDFSClient is not supported"):
        utils.HDFSClient()


# ---- models across degrees ---------------------------------------------------------

# tiny Llama with 4 KV heads, so it splits at mp 4
FIELDS = {"num_key_value_heads": 4}


@pytest.fixture(scope="module")
def oracle():
    """The JAX single-device run: the tiny Llama from seed 0 through four
    AdamW steps (the weights before, the losses, the batches)."""
    batches = [np.random.RandomState(30 + s).randint(0, 256, (4, 16))
               .astype(np.int64) for s in range(4)]
    arrays, losses, _, _ = jax_train("llama", FIELDS, batches)
    return arrays, losses, batches


def _save_then_resume(pools, tmp_path, oracle, save_on, resume_on):
    """Two steps under ``save_on`` (n, hybrid, zero), ``save_checkpoint``,
    then a model from another seed under each of ``resume_on`` loads it
    and takes the next two steps; every loss against the JAX run."""
    arrays, losses, batches = oracle
    path = str(tmp_path / "step_0")
    n, hybrid, zero = save_on
    saved = pools(n).run("torch_ckpt_cases:llama_save", FIELDS, arrays,
                         batches[:2], hybrid, path, zero)
    for n, hybrid, zero in resume_on:
        got = pools(n).run("torch_ckpt_cases:llama_resume", FIELDS,
                           batches[2:], hybrid, path, zero)
        assert [g["step0"] for g in got] == [2] * n
        assert [g["epoch"] for g in got] == [0] * n
        check_losses(np.concatenate([replica_mean(saved),
                                     replica_mean(got)]), losses)


def test_llama_saved_at_mp2_resumes_at_mp1_mp4_and_dp2(pools, tmp_path,
                                                       oracle):
    _save_then_resume(pools, tmp_path, oracle, (2, {"mp_degree": 2}, None),
                      [(1, {"mp_degree": 1}, None),
                       (4, {"mp_degree": 4}, None),
                       (2, {"dp_degree": 2}, None)])


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_zero_over_sharding2_resumes_at_mp1_and_mp2(pools, tmp_path, oracle,
                                                    level):
    """ZeRO stage 2 (owners' whole slots) and stage 3 (flat slices of
    every parameter and slot) over sharding 2, resumed without ZeRO."""
    _save_then_resume(
        pools, tmp_path, oracle,
        (2, {"sharding_degree": 2, "dp_degree": 1}, level),
        [(1, {"mp_degree": 1}, None), (2, {"mp_degree": 2}, None)])


def test_one_process_save_resumes_at_mp2_and_zero3(pools, tmp_path, oracle):
    _save_then_resume(
        pools, tmp_path, oracle, (1, {"mp_degree": 1}, None),
        [(2, {"mp_degree": 2}, None),
         (2, {"sharding_degree": 2, "dp_degree": 1}, "p_g_os")])
