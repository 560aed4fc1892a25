"""Data parallelism and ZeRO sharding of the port (``distributed.
parallel.DataParallel``, ``fleet.sharding``: ``DygraphShardingOptimizer``
stages 1/2, ``GroupShardedStage3``, ``group_sharded_parallel``,
``save_group_sharded_model``; the hybrid clip over the sharding group)
over 2 and 4 gloo ranks on the CPU, against the JAX package's
single-device eager run on the same weights (the oracle of
``tests/test_sharding.py:107``/``:131``).

Each rank trains on its data replica's rows of the global batch; the
replicas' mean loss a step is held to the JAX loss (``rtol=1e-5`` at the
first step, ``1e-4`` after AdamW steps), the averaged gradients to
``rtol=1e-4`` and the final weights as in
``tests/test_torch_tensor_parallel.py``. The ranks are started once a
module (``torch_dist_pool.RankPool``) and run ``torch_dist_cases``.
"""

from __future__ import annotations

import math

import pytest
import torch

from test_torch_tensor_parallel import (LR, WD, _batches, check_grads,
                                        check_losses, check_weights,
                                        jax_train, replica_mean)
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


def _run(pools, n, hybrid, fields=None, zero=None, micro=1, clip=None,
         shape=(8, 16)):
    fields = fields or {}
    batches = _batches(shape=shape)
    arrays, losses, grads0, after = jax_train("llama", fields, batches,
                                              clip=clip)
    got = pools(n).run("torch_dist_cases:train_steps", "llama", fields,
                       arrays, batches, hybrid, LR, WD, clip, zero, None,
                       micro)
    check_losses(replica_mean(got), losses)
    check_weights(got[0]["weights"], after)
    return got, grads0, arrays


@pytest.mark.parametrize("dp,micro", [(2, 1), (2, 2), (4, 2)])
def test_data_parallel_matches_the_single_device_jax_run(pools, dp, micro):
    """fleet.distributed_model wraps the model in DataParallel over the
    data group; the gradients are averaged at the end of each synced
    backward, and ``no_sync`` accumulates the micro-batches locally
    first: the averaged gradients, the mean loss and the weights equal
    the JAX run on the whole batch."""
    got, grads0, _ = _run(pools, dp, {"dp_degree": dp}, micro=micro)
    for res in got:
        assert res["n_rep"] == dp
        check_grads(res["grads0"], grads0)


@pytest.mark.parametrize("level,n", [("os", 2), ("os_g", 2), ("p_g_os", 2),
                                     ("os_g", 4), ("p_g_os", 4)])
def test_zero_stages_match_and_partition_the_state(pools, level, n):
    """group_sharded_parallel at each level: the losses and weights equal
    the JAX run; stages 1/2 hold the moments of their own partition only
    (whole parameters, summing to every parameter once), stage 3 its
    slice of every parameter (and the moments of the slices)."""
    got, _, arrays = _run(pools, n, {"sharding_degree": n, "dp_degree": 1},
                          zero=level)
    total = sum(a.size for a in arrays.values())
    states = [res["state_numel"] for res in got]
    if level == "p_g_os":
        slices = sum(math.ceil(a.size / n) for a in arrays.values())
        for res in got:
            assert res["param_numel"] == slices
            assert res["state_numel"] == 2 * slices
    else:
        # two f32 moments a parameter, no master copy (f32 weights)
        assert sum(states) == 2 * total
        assert all(0 < s < 2 * total for s in states)


def test_sharding_by_model_parallel_matches_jax(pools):
    """sharding 2 x mp 2 through fleet.distributed_optimizer (ZeRO stage
    1 over the sharding group of split parameters) with a global-norm
    clip that clips: the losses and weights equal the JAX run's (the
    oracle of tests/test_sharding.py:148)."""
    got, _, _ = _run(pools, 4, {"sharding_degree": 2, "mp_degree": 2},
                     clip=0.05)
    for res in got:
        assert res["n_rep"] == 2


def test_zero2_hybrid_clip_matches_the_jax_clip(pools):
    """Stage 2 with ClipGradByGlobalNorm: each rank's partition of the
    squares summed over the sharding group gives the JAX global norm."""
    _run(pools, 2, {"sharding_degree": 2, "dp_degree": 1}, zero="os_g",
         clip=0.05)


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_save_group_sharded_model_gathers(pools, tmp_path, level):
    """save_group_sharded_model writes the full model (and the optimizer)
    from the first rank: the weights after one step are the JAX run's."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.framework.io import load
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    batches = _batches(steps=1, shape=(4, 16))
    arrays, _, _, after = jax_train("llama", {}, batches)
    out = tmp_path / level
    got = pools(2).run("torch_dist_cases:sharded_save", arrays, batches[0],
                       level, str(out))
    assert got[0] == ["model.pdopt", "model.pdparams"]
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_state_dict(load(str(out / "model.pdparams"), device="cpu"))
    check_weights(convert.to_numpy_state_dict(model), after)
    opt = load(str(out / "model.pdopt"), device="cpu")
    shapes = [tuple(v.shape) for k, v in opt.items()
              if k.endswith("_moment1")]
    assert sorted(shapes) == sorted(tuple(p.shape)
                                    for p in model.parameters())


def test_zero3_refuses_recompute_inside_the_model(pools):
    """Stage 3 drops the gathered parameters after the forward, so a
    model that recomputes inside it is refused, naming ROADMAP A.7."""
    for msg in pools(2).run("torch_dist_cases:zero3_recompute_refused"):
        assert msg is not None and "ROADMAP A.7" in msg
