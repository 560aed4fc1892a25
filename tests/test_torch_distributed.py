"""The port's process group, collectives and hybrid topology
(``distributed.env``, ``communication``, ``spawn_api``,
``fleet.topology``, ``fleet.base``, ``parallelize``) over 1, 2 and 4 gloo
ranks on the CPU, and what ``DistributedBatchSampler``, the checkpoint
writers and ``convert`` do under a fleet.

The ranks are started once a module (``torch_dist_pool.RankPool``) and
run ``torch_dist_cases``. Collectives are held to exact values (small
integers in f32); the JAX package's ``CommunicateTopology`` is the
oracle of the coordinates; the parallelised MLP is held to the JAX
package's plain layers at ``rtol=1e-5``. The checkpoint writers' case
runs ``torch_ckpt_cases``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fleet.topology import \
    CommunicateTopology as JTopology
from paddle_tpu import nn as jnn
import paddle_tpu as paddle

from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed.fleet import base as tbase
from paddle_tpu_torch.distributed.fleet.topology import CommunicateTopology

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


# ---- collectives ----------------------------------------------------------------

def _expected(n):
    """Each rank's results of torch_dist_cases.collectives at world n."""
    vals = np.arange(1, n + 1, dtype=np.float32)
    out = []
    for r in range(n):
        e = {"all_reduce_sum": np.full(3, vals.sum()),
             "all_reduce_max": np.full(3, vals.max()),
             "all_reduce_min": np.full(3, vals.min()),
             "all_reduce_prod": np.full(3, vals.prod()),
             "all_reduce_avg": np.full(3, vals.mean()),
             "all_reduce_strided": np.arange(6.0).reshape(2, 3).T
             * vals.sum(),
             "all_gather": [np.full(3, 10.0 * (k + 1)) for k in range(n)],
             "all_gather_object": [{"r": k} for k in range(n)],
             "reduce_scatter": np.array(
                 [sum(2 * r + i + 100 * k for k in range(n))
                  for i in range(2)], np.float32),
             "alltoall": [np.full(2, 10.0 * k + r) for k in range(n)],
             "alltoall_single": np.array([10.0 * k + r for k in range(n)]),
             "broadcast": np.full(2, n - 1.0),
             "broadcast_object_list": ["from1", 1],
             "scatter": np.full(2, float(r)),
             "scatter_object_list": [f"s{r}"],
             "sendrecv": np.full(2, float((r - 1) % n)),
             "batch_p2p": np.full(2, 2.0 * ((r - 1) % n))}
        e["reduce_scatter_avg"] = e["reduce_scatter"] / n
        start = sum(j + 1 for j in range(r))
        e["alltoall_uneven"] = np.concatenate(
            [np.arange(start, start + r + 1) + 100.0 * k for k in range(n)])
        if r == 0:
            e["reduce"] = np.full(2, vals.sum())
            e["gather"] = [np.full(1, float(k)) for k in range(n)]
        else:
            e["reduce"] = np.full(2, r + 1.0)
            e["gather"] = []
        evens = [k for k in range(n) if k % 2 == 0]
        if r % 2 == 0:
            e["subgroup"] = np.full(1, float(sum(evens)))
            e["subgroup_rank"] = evens.index(r)
        else:
            e["subgroup_rank"] = -1
        out.append(e)
    return out


def _same(got, want, what):
    if isinstance(want, list):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, what)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("n,staged", [(2, False), (4, False), (2, True),
                                      (4, True)])
def test_every_collective_at_2_and_4_ranks(pools, n, staged):
    """all_reduce (each op, and a strided tensor), all_gather(_object),
    reduce_scatter (sum and mean, the gloo build), alltoall and
    alltoall_single (even and uneven splits, the gloo build), broadcast
    (_object_list), reduce, scatter(_object_list), gather, send/recv,
    batch_isend_irecv and a subgroup: exact values on every rank.
    ``staged`` runs them through the backend rule's host buffers, as gloo
    runs CUDA tensors."""
    got = pools(n).run("torch_dist_cases:collectives", staged)
    for r, (res, want) in enumerate(zip(got, _expected(n))):
        assert res["rank"] == r and res["world"] == n
        assert res["backend"] == "gloo"
        for key, val in want.items():
            _same(res[key], val, f"rank {r}: {key}")


def test_backend_rule(monkeypatch):
    """gloo on the CPU and where ranks share a card, nccl with a card a
    rank; nccl asked for with more ranks than cards (or on the CPU)
    raises: no quiet fallback."""
    rule = tenv.backend_rule
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert rule(cpu, 4) == "gloo"
    with pytest.raises(ValueError, match="CPU"):
        rule(cpu, 1, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rule(card, 1) == "nccl"
    assert rule(card, 2) == "gloo"
    assert rule(card, 2, "gloo") == "gloo"
    with pytest.raises(ValueError, match="2 ranks on 1 card"):
        rule(card, 2, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rule(card, 4) == "nccl"
    with pytest.raises(ValueError, match="not 'gloo' or 'nccl'"):
        rule(card, 1, "mpi")


def test_init_without_a_rendezvous_or_a_device_raises(monkeypatch):
    """A world of two with no address fails at once; with no GPU and no
    device asked for, init fails: a rank that cannot reach its device or
    its group fails."""
    for name in ("PADDLE_MASTER", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    with pytest.raises(RuntimeError, match="rendezvous"):
        tenv.init_parallel_env(device="cpu")
    assert not tenv.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenv.init_parallel_env()
    assert not tenv.is_initialized()
    # before any init, the launcher's variables answer
    assert tenv.get_world_size() == 2 and tenv.get_rank() == 0


# ---- topology and fleet.init ------------------------------------------------------

@pytest.mark.parametrize("names,dims", [
    (("data", "sharding", "pipe", "sep", "model", "expert"),
     (2, 1, 1, 1, 2, 1)),
    (("data", "sharding", "pipe", "sep", "model", "expert"),
     (1, 2, 1, 1, 2, 2)),
    (("data", "pipe", "sharding", "sep", "model"), (2, 2, 1, 1, 2))])
def test_communicate_topology_matches_jax(names, dims):
    j, t = JTopology(names, dims), CommunicateTopology(names, dims)
    assert t.world_size() == j.world_size()
    for rank in range(j.world_size()):
        assert t.get_coord(rank) == j.get_coord(rank)
        assert t.get_rank(**j.get_coord(rank)) == rank
    for name in names:
        assert t.get_dim(name) == j.get_dim(name)
        assert t.get_comm_list(name) == j.get_comm_list(name)
        for i in range(j.get_dim(name)):
            assert t.get_axis_list(name, i) == j.get_axis_list(name, i)


def test_hybrid_degrees_arithmetic_and_errors():
    """The JAX arithmetic (dp -1 fills) against the world size; a product
    other than the world size raises; pp, sep and ep above 1 raise,
    naming their ROADMAP items."""
    deg = tbase.hybrid_degrees
    assert deg({"dp_degree": -1, "mp_degree": 2}, 8) == (4, 1, 1, 1, 2, 1)
    assert deg({"dp_degree": 0, "sharding_degree": 2, "mp_degree": 2},
               8) == (2, 2, 1, 1, 2, 1)
    assert deg({"dp_degree": 2, "mp_degree": 2}, 4) == (2, 1, 1, 1, 2, 1)
    with pytest.raises(ValueError, match="exceed the world size 4"):
        deg({"dp_degree": 2, "mp_degree": 4}, 4)
    with pytest.raises(ValueError, match="do not use the world size 8"):
        deg({"dp_degree": 1, "mp_degree": 2}, 8)
    for key, item in (("pp_degree", "A.7, the pipeline"),
                      ("sep_degree", "A.7, context parallelism"),
                      ("ep_degree", "A.5, expert parallelism")):
        with pytest.raises(NotImplementedError, match=item):
            deg({key: 2}, 4)


def test_fleet_init_builds_the_groups_of_each_axis(pools):
    """fleet.init at 4 ranks: degrees, this rank's coordinates and the
    ranks of its group on each axis, as CommunicateTopology gives them;
    the errors reach the caller on every rank."""
    configs = [{"dp_degree": 2, "mp_degree": 2},
               {"dp_degree": -1, "sharding_degree": 2, "mp_degree": 2},
               {"dp_degree": -1, "mp_degree": 4},
               {"dp_degree": 4, "mp_degree": 2},
               {"pp_degree": 2}]
    got = pools(4).run("torch_dist_cases:fleet_degrees", configs)
    names = ("data", "sharding", "pipe", "sep", "model", "expert")
    want_dims = [(2, 1, 1, 1, 2, 1), (1, 2, 1, 1, 2, 1), (1, 1, 1, 1, 4, 1)]
    modes = ["hybrid", "hybrid", "hybrid"]
    for rank, res in enumerate(got):
        for i, dims in enumerate(want_dims):
            status, got_dims, coord, groups, mode = res[i]
            topo = JTopology(names, dims)
            assert status == "ok" and got_dims == list(dims)
            assert coord == topo.get_coord(rank)
            for name in names:
                mine = [g for g in topo.get_comm_list(name) if rank in g][0]
                assert groups[name] == mine, (name, groups[name], mine)
            assert mode == modes[i]
        assert res[3][:2] == ("error", "ValueError")
        assert res[4][:2] == ("error", "NotImplementedError")
        assert "ROADMAP A.7" in res[4][2]


def test_world_size_one_is_the_plain_model_bit_for_bit(pools):
    """At world size 1 a model built under fleet.init and trained through
    distributed_model / distributed_optimizer gives the losses, logits
    and weights of the model without a fleet, bit for bit (Llama scanned
    and unrolled, Qwen2, DeepSeek-V2)."""
    ids = np.random.RandomState(5).randint(0, 256, (2, 12)).astype(np.int64)
    cases = [("llama", {}), ("llama", {"scan_layers": False}),
             ("qwen2", {}), ("deepseek", {})]
    for family, fields in cases:
        assert pools(1).run("torch_dist_cases:world_one", family, fields,
                            ids) == [True], (family, fields)


def test_distributed_batch_sampler_takes_the_process_group(pools):
    """Without arguments the sampler's replicas and rank come from the
    fleet's data x sharding ranks (a model group reads one batch)."""
    got = pools(4).run("torch_dist_cases:sampler_defaults",
                       {"dp_degree": 2, "mp_degree": 2}, 10)
    for rank, (n, r, batches) in enumerate(got):
        assert n == 2 and r == rank // 2
        assert sum(len(b) for b in batches) == 5
    assert got[0][2] == got[1][2] and got[2][2] == got[3][2]
    assert sorted(sum(got[0][2] + got[2][2], [])) == list(range(10))


def test_split_model_writers_save_and_resume_at_mp2(pools, tmp_path):
    """Under mp 2 the checkpoint writers that refused a split model save
    and resume it: Model.save writes the unsharded model's .pdparams
    from the first rank (one process loads it to the JAX logits) and
    Model.load takes each rank's slice; distributed.checkpoint's
    save_state_dict/load_state_dict of model.state_dict() place each
    shard; fit(save_dir=) then fit(resume=True) continues at epoch 1. A
    cache step still raises, naming ROADMAP A.7, and
    convert.to_numpy_state_dict gathers the JAX package's full shapes.
    The logits after each load equal the saved model's bit for bit, the
    JAX model's within rtol 1e-5 (the sums' order)."""
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.hapi import Model as TModel
    from paddle_tpu_torch.models import LlamaConfig as TConfig
    from paddle_tpu_torch.models import LlamaForCausalLM as TLlama
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.tiny())
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(3).randint(0, 256, (2, 8)).astype(np.int64)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    got = pools(2).run("torch_ckpt_cases:split_model_writers", arrays, ids,
                       str(tmp_path))
    shapes = {k: v.shape for k, v in arrays.items()}
    for res in got:
        assert res["files"] == ["x.pdopt", "x.pdparams"]
        np.testing.assert_allclose(res["logits"], want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(res["after_load"], res["logits"])
        np.testing.assert_array_equal(res["after_ckpt"], res["logits"])
        assert res["resumed_epochs"] == [1] and res["resumed_step"] == 2
        assert res["cache_step"] is not None and "A.7" in res["cache_step"]
        assert {k: tuple(v) for k, v in res["full_shapes"].items()} == shapes
    one = TModel(TLlama(TConfig.tiny(), device="cpu", seed=9))
    one.load(str(tmp_path / "x"))
    with torch.no_grad():
        np.testing.assert_allclose(
            one.network(torch.from_numpy(ids)).numpy(), want, rtol=1e-5,
            atol=1e-6)


def test_parallelize_plan_matches_the_plain_jax_mlp(pools):
    """parallelize with ColWise fc1 and RowWise fc2 at mp 2: the layers
    become the parallel ones, and the output and gradients equal the JAX
    MLP's on the full weights."""
    rng = np.random.RandomState(0)
    f = np.float32
    a = {"x": rng.randn(2, 5, 8).astype(f),
         "w1": (rng.randn(8, 12) * 0.3).astype(f),
         "b1": rng.randn(12).astype(f),
         "w2": (rng.randn(12, 8) * 0.3).astype(f),
         "b2": rng.randn(8).astype(f),
         "dy2": rng.randn(2, 5, 8).astype(f)}
    fc1, fc2 = jnn.Linear(8, 12), jnn.Linear(12, 8)
    for layer, w, b in ((fc1, "w1", "b1"), (fc2, "w2", "b2")):
        layer.weight.set_value(a[w])
        layer.bias.set_value(a[b])
    y = fc2(paddle.nn.functional.relu(fc1(paddle.to_tensor(a["x"]))))
    (y * paddle.to_tensor(a["dy2"])).sum().backward()
    for res in pools(2).run("torch_dist_cases:parallelized_mlp", a):
        assert res["types"] == ["ColumnParallelLinear", "RowParallelLinear"]
        np.testing.assert_allclose(res["y"], y.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["dw1"], fc1.weight.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["dw2"], fc2.weight.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["db2"], fc2.bias.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_spawn_runs_the_ranks_and_a_failed_rank_fails_it(tmp_path):
    """distributed.spawn: two ranks join at a free port and all-reduce;
    a rank that exits nonzero makes spawn raise and stops the other."""
    from paddle_tpu_torch.distributed import spawn
    import torch_dist_cases
    out = tmp_path / "sum"
    spawn(torch_dist_cases.spawned_rank, args=(str(out),), nprocs=2,
          timeout=120)
    for r in range(2):
        assert (tmp_path / f"sum.{r}").read_text() == "2 3.0"
    with pytest.raises(RuntimeError, match=r"ranks \[1\] exited nonzero"):
        spawn(torch_dist_cases.spawned_rank, args=(str(out) + "x", 1),
              nprocs=2, timeout=120)


def test_package_names_load_lazily():
    """The distributed and fleet packages name every ported API and load
    it at first use (the launcher imports neither torch nor numpy)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    for name in ("init_parallel_env", "all_reduce", "alltoall_single",
                 "DataParallel", "ColumnParallelLinear", "spawn",
                 "parallelize", "ReduceOp", "get_backend", "gloo_barrier"):
        assert name in dist.__all__ and getattr(dist, name) is not None
    for name in ("init", "DistributedStrategy", "HybridCommunicateGroup",
                 "distributed_model", "distributed_optimizer",
                 "group_sharded_parallel", "meta_parallel", "utils",
                 "elastic"):
        assert getattr(fleet, name) is not None
    assert dist.sharding.save_group_sharded_model is not None
    assert "TensorParallel" in fleet.meta_parallel.__all__
