"""Expert parallelism of the port at the op and layer level
(``ops.moe.moe_forward_ep`` over an ``expert`` group, ``MoELayer`` under
``fleet.init`` at ``ep_degree > 1``) over 2 and 4 gloo ranks on the CPU,
against the JAX package, and the refusals that remain. The models are in
``tests/test_torch_expert_parallel_models.py``, pp x ep in
``tests/test_torch_expert_parallel_pipe.py``.

The same inputs (numpy from a seed) go through the JAX functions under
``shard_map`` over the conftest's CPU devices (``tests/test_moe.py``'s
construction) or the JAX layer under the JAX ``fleet.init(ep_degree=)``,
and through the port on that many ranks (``torch_dist_pool.RankPool``
running ``torch_ep_cases``), each rank on its block of the tokens and of
the experts. The capacity factor 1.25 drops tokens; the capacity is per
rank in both packages, so the kept slots match exactly.

Tolerances: f32 outputs ``rtol=1e-5, atol=2e-6``, aux and z ``rtol=
1e-6``, gradients ``rtol=1e-4, atol=1e-5`` (the f32 sums of the JAX
einsums and of ``torch.bmm`` in other orders).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:                                  # jax <= 0.4.x
    from jax.experimental.shard_map import shard_map

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoELayer
from paddle_tpu.ops import moe as jmoe

import paddle_tpu_torch.distributed as tdist

from torch_dist_pool import RankPool

torch.set_num_threads(1)

OUT_TOL = dict(rtol=1e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pools():
    """One pool alive at a time (the tests are ordered by world size)."""
    made = {}

    def get(n):
        if n not in made or not made[n].alive():
            for m in [m for m in made if m != n]:
                made.pop(m).close()
            made[n] = RankPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


def _mk(T=32, d=8, h=16, E=8, seed=0):
    r = np.random.RandomState(seed)

    def f(*s, scale=1.0):
        return (r.randn(*s) * scale).astype(np.float32)

    return (f(T, d), f(d, E), f(E, d, h, scale=0.3), f(E, d, h, scale=0.3),
            f(E, h, d, scale=0.3), f(T, d))


def _jax_ep(n, x, rw, wg, wu, wd, wl, k, cf, ntp, ca, cz):
    """The JAX ``moe_forward_ep`` under ``shard_map`` over ``n`` CPU
    devices, and ``jax.grad`` of ``sum(y * wl) + ca * aux + cz * z``."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("expert",))

    def loss(args):
        f = shard_map(
            lambda xf, rwl, a, b, c: jmoe.moe_forward_ep(
                xf, rwl, lambda t: jmoe.moe_ffn_grouped(t, a, b, c),
                "expert", k=k, capacity_factor=cf, norm_topk_prob=ntp),
            mesh=mesh,
            in_specs=(P("expert"), P(None, None), P("expert"),
                      P("expert"), P("expert")),
            out_specs=(P("expert"), P(), P()))
        y, aux, z = f(*args)
        return (y * wl).sum() + ca * aux + cz * z, (y, aux, z)

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tuple(jnp.asarray(a) for a in (x, rw, wg, wu, wd)))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


# ---- the op at degree 2 and 4 ---------------------------------------------------

# name: (k, capacity factor, norm_topk_prob, aux coef, z coef, seed)
OP_CASES = {"top2 drops": (2, 1.25, True, 0.3, 0.2, 0),
            "top1 drops": (1, 1.25, False, 0.5, 0.0, 1),
            "top2 no drop": (2, 4.0, False, 0.1, 0.05, 2)}


@pytest.mark.parametrize("n", [2, 4])
def test_moe_forward_ep_matches_jax(pools, n):
    """Outputs, aux, z, the gradients of x, the router (summed over the
    group) and each rank's bank block, and the kept slots against the
    JAX ``moe_forward_ep`` under ``shard_map``: a capacity that drops
    tokens (1.25, per rank in both), top-1 and top-2, and one that keeps
    every token."""
    cases = [(name, *_mk(seed=seed), k, cf, ntp, ca, cz)
             for name, (k, cf, ntp, ca, cz, seed) in OP_CASES.items()]
    got = pools(n).run("torch_ep_cases:ep_ops", cases)
    for name, x, rw, wg, wu, wd, wl, k, cf, ntp, ca, cz in cases:
        (y, aux, z), grads = _jax_ep(n, x, rw, wg, wu, wd, wl, k, cf, ntp,
                                     ca, cz)
        res = [r[name] for r in got]
        np.testing.assert_allclose(np.concatenate([r[0] for r in res]), y,
                                   err_msg=name, **OUT_TOL)
        for r in res:
            np.testing.assert_allclose(r[1], float(aux), rtol=1e-6)
            np.testing.assert_allclose(r[2], float(z), rtol=1e-6)
            # the router's gradient is the whole one on every rank
            np.testing.assert_allclose(r[4], grads[1], err_msg=name,
                                       **GRAD_TOL)
        np.testing.assert_allclose(np.concatenate([r[3] for r in res]),
                                   grads[0], err_msg=name, **GRAD_TOL)
        for i in range(3):
            np.testing.assert_allclose(
                np.concatenate([r[5 + i] for r in res]), grads[2 + i],
                err_msg=f"{name} bank {i}", **GRAD_TOL)
        # the kept slots: each shard's routing in the JAX package
        T = x.shape[0] // n
        cap = max(int(cf * k * T / rw.shape[1]), 1)
        dropped = 0
        gating = jax.jit(lambda xs: jmoe.top_k_gating_idx(
            xs @ jnp.asarray(rw), k, cap, ntp))
        for rank, r in enumerate(res):
            gi, _, pos, keep, _, _ = gating(
                jnp.asarray(x[rank * T:(rank + 1) * T]))
            np.testing.assert_array_equal(r[8], np.asarray(gi))
            np.testing.assert_array_equal(r[9], np.asarray(pos))
            np.testing.assert_array_equal(r[10], np.asarray(keep))
            dropped += int((~r[10]).sum())
        assert (dropped > 0) == (cf < 2), (name, dropped)


# ---- MoELayer under fleet ---------------------------------------------------------

def _jax_layer(n, x, wl, gate, coef):
    """The JAX ``MoELayer`` from seed 3 under the JAX ``fleet.init(
    ep_degree=n)``: its full weights, output, aux, z and the gradients
    of ``sum(out * wl) + coef * aux``."""
    from conftest import reset_fleet_state
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1, "sep_degree": 1,
                        "ep_degree": n}
    jfleet.init(strategy=s)
    try:
        paddle.seed(3)
        layer = JMoELayer(x.shape[-1], 16, 8, gate=dict(gate))
        weights = {k: np.asarray(v.numpy())
                   for k, v in layer.state_dict().items()}
        jx = paddle.to_tensor(x, stop_gradient=False)
        y = layer(jx)
        ((y * paddle.to_tensor(wl)).sum() + coef * layer.aux_loss).backward()
        return weights, {
            "y": np.asarray(y.numpy()), "aux": float(layer.aux_loss.numpy()),
            "z": float(layer.z_loss.numpy()), "dx": np.asarray(
                jx.grad.numpy()),
            "grads": {k: np.asarray(p.grad.numpy())
                      for k, p in layer.named_parameters()}}
    finally:
        reset_fleet_state()


@pytest.mark.parametrize("n", [2, 4])
def test_moe_layer_under_fleet_ep_matches_the_jax_layer(pools, n):
    """``MoELayer`` under ``fleet.init(ep_degree=n)`` against the JAX
    layer under its own: the same weights through the bridge (each rank
    takes its block of the banks), a capacity that drops tokens; the
    output, aux, z and the gradients (x and the router whole on every
    rank, each bank block the rank's part of the JAX bank's). Each rank
    holds E/ep experts, marked ``_ep_shard_dim`` 0 with the checkpoint
    layout ``split=(0, rank, ep), axes=("expert",)``, and the bridge
    gathers them back whole. A ``dropless`` gate takes the capacity path
    with the JAX warning and logs ``moe/dropless_downgraded`` once."""
    gate = {"top_k": 2, "capacity_factor": 1.25, "norm_topk_prob": False}
    rng = np.random.RandomState(7)
    x = rng.randn(4, 8, 8).astype(np.float32)
    wl = rng.randn(4, 8, 8).astype(np.float32)
    weights, want = _jax_layer(n, x, wl, gate, 0.5)
    got = pools(n).run("torch_ep_cases:ep_layer", x, weights, wl, gate, 0.5,
                       {"ep_degree": n, "dp_degree": 1})
    for rank, res in enumerate(got):
        np.testing.assert_allclose(res["y"], want["y"], **OUT_TOL)
        np.testing.assert_allclose(res["aux"], want["aux"], rtol=1e-6)
        np.testing.assert_allclose(res["z"], want["z"], rtol=1e-6)
        np.testing.assert_allclose(res["dx"], want["dx"], **GRAD_TOL)
        np.testing.assert_allclose(res["grads"]["router_weight"],
                                   want["grads"]["router_weight"],
                                   **GRAD_TOL)
        for name in ("w_gate", "w_up", "w_down"):
            per = 8 // n
            np.testing.assert_allclose(
                res["grads"][name],
                want["grads"][name][rank * per:(rank + 1) * per],
                err_msg=name, **GRAD_TOL)
            assert res["shapes"][name][0] == per
            assert res["layouts"][name] == ((0, rank, n), ("expert",))
            assert res["shard_dims"][name] == 0
            np.testing.assert_array_equal(res["full"][name], weights[name])
        assert res["shapes"]["router_weight"] == (8, 8)
        assert "router_weight" not in res["layouts"]
        assert len(res["warnings"]) == 2 and "dropless=True requested" in \
            res["warnings"][0] and f"ep_degree={n}" in res["warnings"][0]
        assert len(res["events"]) == 1, res["events"]


def test_fleet_and_the_loader_at_ep2(pools):
    """``fleet.init(ep_degree=2)`` on 4 ranks: the degrees (1, 1, 1, 1, 1,
    2) with dp filling to 2, the expert groups over the ranks that differ
    only along ``expert``, and a ``DistributedBatchSampler`` that gives
    both ranks of an expert group the same indices (the data rank, not
    the global rank)."""
    got = pools(4).run("torch_ep_cases:ep_topology")
    for rank, res in enumerate(got):
        assert res["dims"] == [2, 1, 1, 1, 1, 2]
        assert res["expert_ranks"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert res["ep_rank"] == rank % 2 and res["dp_rank"] == rank // 2
        assert res["data_ranks"] == [rank % 2, rank % 2 + 2]
        assert res["indices"] == got[rank ^ 1]["indices"]
        assert res["indices"] != got[rank ^ 2]["indices"]
        assert "ep2" in res["event"]


def test_the_refusals_that_remain(pools):
    """On 4 ranks: a token count that ep does not divide, an expert count
    that ep does not divide (the JAX messages), ep x sep (the JAX
    refusal, naming ROADMAP A.7), ep x ZeRO (ROADMAP A.7) and a
    ``generate`` step of a model built at ep > 1 (ROADMAP A.7) each
    raise."""
    got = pools(4).run("torch_ep_cases:ep_refusals")
    for res in got:
        assert res["tokens"] == ("ValueError",
                                 "token count 5 not divisible by ep 4")
        assert res["experts"] == (
            "ValueError", "num_experts 17 not divisible by ep degree 4")
        assert res["sep"][0] == "ValueError"
        assert "ep_degree > 1 with sep_degree > 1" in res["sep"][1]
        assert "A.7" in res["sep"][1]
        assert res["zero"][0] == "NotImplementedError"
        assert "A.7" in res["zero"][1]
        assert res["generate"][0] == "NotImplementedError"
        assert "expert parallelism" in res["generate"][1]


def test_global_scatter_and_gather_point_to_the_ep_path():
    """The count-based primitives raise, as in the JAX package
    (``tests/test_dist_misc.py``), naming the path that does EP."""
    for fn in (tdist.utils.global_scatter, tdist.utils.global_gather):
        with pytest.raises(NotImplementedError, match="MoE") as e:
            fn(None, None, None)
        assert "MoELayer" in str(e.value)
        assert "moe_forward_ep" in str(e.value)
        assert "A.5" not in str(e.value)
