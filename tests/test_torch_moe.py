"""The port's MoE slice against the JAX package, on the CPU: the routing
(``sort_rows_by_expert``, ``top_k_gating_idx``, ``top_k_gating``), the
dropless and capacity forwards with their gradients, ``MoELayer``'s two
branches, Qwen2 and Qwen2-MoE ``tiny`` in training (fused carry on and
off, recompute, the router aux loss), the weight bridge on the Qwen2-MoE
keys, and greedy streams of Qwen2-MoE ``tiny`` through both engines.

Inputs come from numpy seeds; the models share weights through
``convert.from_numpy_state_dict``. Everything runs in f32; the JAX
package's grouped matmul runs its Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoELayer
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import Qwen2Config as JQwen2Config
from paddle_tpu.models import Qwen2ForCausalLM as JQwen2ForCausalLM
from paddle_tpu.models import Qwen2MoeConfig as JQwen2MoeConfig
from paddle_tpu.models import Qwen2MoeForCausalLM as JQwen2MoeForCausalLM
from paddle_tpu.ops import moe as jmoe

from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.models import (Qwen2Config, Qwen2ForCausalLM,
                                     Qwen2MoeConfig, Qwen2MoeForCausalLM)
from paddle_tpu_torch.ops import moe as tmoe

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


# ---- the routing -------------------------------------------------------------

@pytest.mark.parametrize("T,k,E,bm", [(33, 2, 5, 8), (40, 4, 6, 128),
                                      (7, 1, 9, 8)])
def test_sort_rows_by_expert_matches_exactly(T, k, E, bm):
    rng = np.random.RandomState(T)
    # uneven groups; expert 1 never picked
    gate_idx = rng.choice([0, 2, 3, E - 1], (T, k),
                          p=[0.55, 0.2, 0.15, 0.1]).astype(np.int32)
    jperm, jgid, jP = jmoe.sort_rows_by_expert(jnp.asarray(gate_idx), E,
                                               bm=bm)
    tperm, tgid, tP = tmoe.sort_rows_by_expert(_t(gate_idx), E, bm=bm)
    assert tP == jP
    assert tperm.dtype == tgid.dtype == torch.int32
    np.testing.assert_array_equal(tperm.numpy(), _np(jperm))
    np.testing.assert_array_equal(tgid.numpy(), _np(jgid))


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("capacity", [3, 100])
def test_top_k_gating_matches(norm, capacity):
    rng = np.random.RandomState(7)
    T, E, k = 24, 6, 2
    logits = rng.randn(T, E).astype(np.float32)
    j = jmoe.top_k_gating_idx(jnp.asarray(logits), k, capacity, norm)
    t = tmoe.top_k_gating_idx(_t(logits), k, capacity, norm)
    # indices, queue positions and drops exactly
    for a, b in zip(t[:1] + t[2:4], j[:1] + j[2:4]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    # gate values and the two losses: f32, another summation order
    for a, b in ((t[1], j[1]), (t[4], j[4]), (t[5], j[5])):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)
    jd = jmoe.top_k_gating(jnp.asarray(logits), k, capacity, norm)
    td = tmoe.top_k_gating(_t(logits), k, capacity, norm)
    np.testing.assert_array_equal(td[0].numpy(), _np(jd[0]))
    for a, b in zip(td[1:], jd[1:]):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)


# ---- the forwards --------------------------------------------------------------

def _moe_inputs(seed=2, T=32, d=16, h=24, E=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(T, d).astype(np.float32),
            (rng.randn(d, E) * 0.3).astype(np.float32),
            (rng.randn(E, d, h) * 0.2).astype(np.float32),
            (rng.randn(E, d, h) * 0.2).astype(np.float32),
            (rng.randn(E, h, d) * 0.2).astype(np.float32),
            rng.randn(T, d).astype(np.float32)]


@pytest.mark.parametrize("path", ["dropless_bm128", "capacity"])
def test_moe_forward_and_grads_match(path):
    """Output, aux, z and the grads of x, the router and the banks of
    sum(y * gy) + aux + 0.1 z, in f32 (a capacity of 3 per expert drops
    assignments on the capacity path; bm 8 is held in
    test_torch_moe_kernels.py)."""
    *args, gy = _moe_inputs()
    k = 2

    def jf(x, rw, wg, wu, wd):
        if path == "capacity":
            return jmoe.moe_forward(
                x, rw, lambda t: jmoe.moe_ffn_grouped(t, wg, wu, wd), k=k,
                capacity_factor=0.4, norm_topk_prob=True)
        return jmoe.moe_forward_dropless(x, rw, wg, wu, wd, k=k,
                                         bm=int(path[11:]))

    def tf(x, rw, wg, wu, wd):
        if path == "capacity":
            return tmoe.moe_forward(
                x, rw, lambda t: tmoe.moe_ffn_grouped(t, wg, wu, wd), k=k,
                capacity_factor=0.4, norm_topk_prob=True)
        return tmoe.moe_forward_dropless(x, rw, wg, wu, wd, k=k,
                                         bm=int(path[11:]))

    def jloss(*a):
        y, aux, z = jf(*a)
        return jnp.sum(y * gy) + aux + 0.1 * z, (y, aux, z)

    (_, (jy, jaux, jz)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
            *[jnp.asarray(a) for a in args])
    targs = [_t(a).requires_grad_() for a in args]
    ty, taux, tz = tf(*targs)
    ((ty * _t(gy)).sum() + taux + 0.1 * tz).backward()
    # f32 through two matmuls and the gate; summation order differs
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(tz.item(), float(jz), rtol=1e-6)
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"),
                          targs, jg):
        np.testing.assert_allclose(a.grad.numpy(), _np(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_layer_matches(dropless):
    d, h, E = 16, 24, 4
    gate = {"top_k": 2, "capacity_factor": 1.0, "norm_topk_prob": False,
            "dropless": dropless}
    paddle.seed(3)
    jl = JMoELayer(d, h, E, gate=gate)
    tl = MoELayer(d, h, E, gate=gate, device="cpu")
    arrays = {k: _np(v.numpy()) for k, v in jl.state_dict().items()}
    assert set(arrays) == set(tl.state_dict())
    convert.from_numpy_state_dict(tl, arrays)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 13, d).astype(np.float32)
    gy = rng.randn(2, 13, d).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jl(jx)
    (jy * paddle.to_tensor(gy)).sum().backward()
    tx = _t(x).requires_grad_()
    ty = tl(tx)
    (ty * _t(gy)).sum().backward()
    assert ty.shape == tx.shape
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy.numpy()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.aux_loss.item(), float(jl.aux_loss.numpy()),
                               rtol=1e-6)
    np.testing.assert_allclose(tl.z_loss.item(), float(jl.z_loss.numpy()),
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad.numpy()),
                               rtol=1e-4, atol=1e-6)
    for name, p in jl.named_parameters():
        np.testing.assert_allclose(
            dict(tl.named_parameters())[name].grad.numpy(),
            _np(p.grad.numpy()), rtol=1e-4, atol=1e-6, err_msg=name)


def test_moe_layer_refuses_expert_parallelism(monkeypatch):
    """Expert parallelism is taken now; what the layer refuses is an
    expert count its fleet's ep degree does not divide. Under a fleet
    whose expert group has 2 ranks (a stand-in topology: building makes
    no collective) the layer holds its block of E/2 experts, drawn whole
    from the generator, so its block equals that of the unsplit layer
    from the same seed; the router is whole. The forward over real
    ranks is in ``tests/test_torch_expert_parallel.py``."""
    from paddle_tpu_torch.distributed.communication import Group
    from paddle_tpu_torch.distributed.fleet import base

    class Hcg:      # this process is the second of two expert ranks
        def get_expert_parallel_world_size(self):
            return 2

        def get_expert_parallel_group(self):
            return Group(-1, [1, 0], None, "expert")

        def get_sep_parallel_world_size(self):
            return 1

    whole = MoELayer(16, 24, 4, device="cpu")
    whole.reset_parameters(torch.Generator().manual_seed(5))
    monkeypatch.setattr(base.fleet, "_hcg", Hcg())
    layer = MoELayer(16, 24, 4, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(5))
    assert layer.ep == 2 and layer.ep_rank == 1
    assert layer.router_weight.shape == (16, 4)
    assert torch.equal(layer.router_weight, whole.router_weight)
    for name in ("w_gate", "w_up", "w_down"):
        p = getattr(layer, name)
        assert torch.equal(p, getattr(whole, name)[2:]), name
        assert p.dist_layout.split == (0, 1, 2) and p._ep_shard_dim == 0
        assert layer.state_dict()[name].dist_layout == p.dist_layout
    assert whole.w_gate.dist_layout is None
    with pytest.raises(ValueError,
                       match="num_experts 5 not divisible by ep degree 2"):
        MoELayer(16, 24, 5, device="cpu")


@pytest.mark.parametrize("build", [lambda: MoELayer(16, 24, 4),
                                   lambda: RMSNorm(16)],
                         ids=["MoELayer", "RMSNorm"])
def test_layer_without_device_raises_where_there_is_no_gpu(build,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


# ---- Qwen2 and Qwen2-MoE in training -------------------------------------------

FLAG = "FLAGS_fused_rmsnorm_residual"


@pytest.fixture
def fused_flag():
    saved = [(reg, dict(reg._registry[FLAG])) for reg in (jflags, tflags)]
    yield
    for reg, ent in saved:
        reg._registry[FLAG] = ent


def _qwen2(moe, **kw):
    jcfg = (JQwen2MoeConfig if moe else JQwen2Config).tiny()
    tcfg = (Qwen2MoeConfig if moe else Qwen2Config).tiny()
    for k, v in kw.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    paddle.seed(0)
    jm = (JQwen2MoeForCausalLM if moe else JQwen2ForCausalLM)(jcfg)
    jm.train()
    arrays = {k: _np(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        (Qwen2MoeForCausalLM if moe else Qwen2ForCausalLM)(tcfg,
                                                          device="cpu"),
        arrays)
    return jm, tm


def _ids(seed=1, shape=(2, 33)):
    return np.random.RandomState(seed).randint(0, 256, shape)


CASES = {
    # name: (moe, config fields)
    "dense": (False, {}),
    "moe_capacity_aux": (True, {}),
    "moe_dropless_aux": (True, {"moe_dropless": True}),
    "moe_dropless_recompute": (True, {
        "moe_dropless": True, "use_recompute": True,
        "router_aux_loss_coef": 0.0, "full_save_interval": 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_qwen2_training_matches_jax(case, fused_flag):
    """Logits, loss and every gradient of a labelled forward and
    backward, f32, the port's fused carry on and off against the JAX
    model's (on, its default; off gives the same numbers there). The aux
    cases run without recompute and the router aux loss at its default
    0.001; the recompute case at aux 0 with every second layer saved
    whole."""
    moe, kw = CASES[case]
    jm, tm = _qwen2(moe, **kw)
    ids = _ids()
    jt = paddle.to_tensor(ids)
    jlogits, jloss = jm(jt, labels=jt)
    jloss.backward()
    jg = {n: _np(p.grad.numpy()) for n, p in jm.named_parameters()
          if p.grad is not None}
    jloss = float(jloss.numpy())
    tt = torch.from_numpy(ids)
    for fused in (True, False):
        tflags.set_flags({FLAG: fused})
        tlogits, tloss = tm(tt, labels=tt)
        tloss.backward()
        tg = convert.grads_to_numpy(tm)
        tm.zero_grad(set_to_none=True)
        # f32 through two layers; matmuls and softmax sum in another order
        np.testing.assert_allclose(tlogits.detach().numpy(),
                                   _np(jlogits.numpy()), rtol=1e-5,
                                   atol=1e-5)
        assert abs(tloss.item() - jloss) <= 1e-5 * abs(jloss)
        assert set(tg) == set(jg) and len(tg) == len(list(tm.parameters()))
        for key in jg:
            np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{key} {fused}")


def test_aux_loss_with_recompute_raises_as_in_jax():
    cfg = Qwen2MoeConfig.tiny()
    cfg.use_recompute = True
    tm = Qwen2MoeForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(_ids())
    with pytest.raises(ValueError, match="router_aux_loss_coef"):
        tm(ids, labels=ids)
    tm.eval()                  # inference with a training config is fine
    assert tm(ids).shape == (2, 33, cfg.vocab_size)


def test_bridge_round_trip_on_the_moe_keys():
    """Biases, router and banks untransposed; the Linear weights,
    shared_expert_gate included, transposed; and back."""
    jm, tm = _qwen2(True)
    arrays = {k: _np(v.numpy()) for k, v in jm.state_dict().items()}
    sd = tm.state_dict()
    for key in ("layers.0.self_attn.q_proj.bias",
                "layers.1.self_attn.v_proj.bias",
                "layers.0.mlp.moe.router_weight", "layers.0.mlp.moe.w_gate",
                "layers.1.mlp.moe.w_up", "layers.1.mlp.moe.w_down"):
        np.testing.assert_array_equal(sd[key].numpy(), arrays[key])
    gate = "layers.0.mlp.shared_expert_gate.weight"
    assert arrays[gate].shape == (64, 1) and sd[gate].shape == (1, 64)
    np.testing.assert_array_equal(sd[gate].numpy(), arrays[gate].T)
    back = convert.to_numpy_state_dict(tm)
    assert set(back) == set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(back[key], arrays[key], err_msg=key)


# ---- serving -----------------------------------------------------------------

SPECS = [(5, 7), (13, 4), (9, 6), (3, 5)]   # (prompt, new)
ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4)


@pytest.mark.parametrize("dropless", [False, True])
def test_qwen2_moe_streams_match_jax_engine(dropless):
    """Greedy streams of Qwen2-MoE tiny through both engines, token for
    token. Both route every row of the step's [slots, chunk] input,
    padding included, so the capacity path drops the same assignments."""
    jm, tm = _qwen2(True, moe_dropless=dropless)
    jm.eval()
    tm.eval()
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 256, (p,)).astype(np.int32) for p, _ in SPECS]
    jeng = JEngine(jm, prompt_buckets=(16,), greedy=True,
                   prefix_cache=False, **ENGINE)
    jids = [jeng.add_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    jby = {r.request_id: r.tokens for r in jeng.run()}
    teng = ContinuousBatchingEngine(tm, prefill_chunk=16, device="cpu",
                                    **ENGINE)
    tids = [teng.add_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    tby = {r.request_id: r.tokens for r in teng.run()}
    for ji, ti, (_, n) in zip(jids, tids, SPECS):
        assert len(jby[ji]) == n
        assert tby[ti] == jby[ji], (ti, tby[ti], jby[ji])
