"""What the ranks of ``torch_dist_pool.RankPool`` run for the expert
parallelism tests (``tests/test_torch_expert_parallel{,_models,_pipe}
.py``): each function runs on every rank and returns numpy arrays or
plain values; the tests hold them against the JAX package. Imports torch
and ``paddle_tpu_torch`` only."""

from __future__ import annotations

import dataclasses
import logging

import torch

from paddle_tpu_torch.distributed import env


def _np(t):
    return t.detach().float().cpu().numpy()


def _fleet(hybrid, pipeline=None):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(hybrid)
    s.pipeline_configs.update(pipeline or {})
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _block(a, n, r):
    """Rank ``r``'s block of ``n`` along dim 0."""
    per = a.shape[0] // n
    return a[r * per:(r + 1) * per]


# ---- the op -------------------------------------------------------------------

def ep_ops(cases):
    """Each case ``(name, x [T, d], rw [d, E], wg, wu, wd, wl [T, d], k,
    cf, ntp, ca, cz)`` over the world as the expert group: this rank's
    block of the tokens and of the banks through
    ``ops.moe.moe_forward_ep``, the router through ``c_identity`` (its
    gradient summed over the group, as ``MoELayer`` passes it), and the
    gradients of the rank's share of ``sum(y * wl) + ca * aux + cz * z``
    (the shares sum to the whole loss). Returns {name: (y, aux, z, dx,
    drw, dwg, dwu, dwd, gate_idx, pos, keep)} of this rank."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_layers import c_identity
    from paddle_tpu_torch.ops import moe as moe_ops
    n, r = env.get_world_size(), env.get_rank()
    group = _fleet({"ep_degree": n, "dp_degree": 1}) \
        .get_expert_parallel_group()
    out = {}
    for name, x, rw, wg, wu, wd, wl, k, cf, ntp, ca, cz in cases:
        xs = torch.from_numpy(_block(x, n, r)).requires_grad_()
        rwt = torch.from_numpy(rw).requires_grad_()
        banks = [torch.from_numpy(_block(w, n, r)).requires_grad_()
                 for w in (wg, wu, wd)]
        y, aux, z = moe_ops.moe_forward_ep(
            xs, c_identity(rwt, group),
            lambda t: moe_ops.moe_ffn_grouped(t, *banks), group, k=k,
            capacity_factor=cf, norm_topk_prob=ntp)
        loss = (y * torch.from_numpy(_block(wl, n, r))).sum() + ca * aux \
            + cz * z
        loss.backward()
        T = xs.shape[0]
        capacity = max(int(cf * k * T / rw.shape[1]), 1)
        gi, _, pos, keep, _, _ = moe_ops.top_k_gating_idx(
            xs.detach().float() @ rwt.detach().float(), k, capacity, ntp)
        out[name] = (_np(y), aux.item(), z.item(), _np(xs.grad),
                     _np(rwt.grad), *[_np(b.grad) for b in banks],
                     gi.numpy(), pos.numpy(), keep.numpy())
    fleet.fleet._reset()
    return out


# ---- MoELayer -----------------------------------------------------------------

def ep_layer(x, weights, wl, gate, coef, hybrid):
    """``MoELayer`` under ``fleet.init(hybrid)`` (its ``expert`` group)
    from the full arrays ``weights`` (router, w_gate, w_up, w_down)
    through the bridge, on the whole input ``x`` [B, S, d] (replicated
    over ``expert``): the output, aux, z, the gradients of ``sum(out *
    wl) + coef * aux`` (x, the router, this rank's bank blocks), the
    banks' shapes and layouts, and the dropless downgrade's warnings and
    perf events for a second layer built with ``dropless``."""
    import warnings

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    hcg = _fleet(hybrid)
    d, h, E = weights["w_gate"].shape[1], weights["w_gate"].shape[2], \
        weights["router_weight"].shape[1]
    layer = MoELayer(d, h, E, gate=dict(gate), device="cpu")
    convert.from_numpy_state_dict(layer, weights, hcg=hcg)
    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt)
    ((y * torch.from_numpy(wl)).sum() + coef * layer.aux_loss).backward()
    res = {"y": _np(y), "aux": layer.aux_loss.item(),
           "z": layer.z_loss.item(), "dx": _np(xt.grad),
           "grads": {n: _np(p.grad) for n, p in layer.named_parameters()},
           "shapes": {n: tuple(p.shape) for n, p in
                      layer.named_parameters()},
           "layouts": {n: (lay.split, lay.axes) for n, t in
                       layer.state_dict().items()
                       if (lay := getattr(t, "dist_layout", None))},
           "shard_dims": {n: getattr(p, "_ep_shard_dim", None)
                          for n, p in layer.named_parameters()},
           "full": convert.to_numpy_state_dict(layer)}
    events = []

    class Catch(logging.Handler):
        def emit(self, record):
            events.append(record.getMessage())

    catch = Catch()
    logger = logging.getLogger("paddle_tpu_torch.perf")
    logger.addHandler(catch)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                MoELayer(d, h, E, gate=dict(gate, dropless=True),
                         device="cpu")
    finally:
        logger.removeHandler(catch)
        logger.setLevel(old)
    res["warnings"] = [str(w.message) for w in caught]
    res["events"] = [e for e in events if "moe/dropless_downgraded" in e]
    fleet.fleet._reset()
    return res


def ep_topology():
    """``fleet.init(ep_degree=2)`` over the world: the degrees, the ranks
    of this rank's expert and data groups, its ep and dp ranks, the
    indices a ``DistributedBatchSampler`` gives it (16 samples, batch 2)
    and the ``fleet/init`` event."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.io import DistributedBatchSampler
    events = []

    class Catch(logging.Handler):
        def emit(self, record):
            events.append(record.getMessage())

    logger = logging.getLogger("paddle_tpu_torch.perf")
    catch, old = Catch(), logger.level
    logger.addHandler(catch)
    logger.setLevel(logging.INFO)
    try:
        hcg = _fleet({"ep_degree": 2})
    finally:
        logger.removeHandler(catch)
        logger.setLevel(old)
    topo = hcg.topology()
    sampler = DistributedBatchSampler(list(range(16)), batch_size=2)
    out = {"dims": [topo.get_dim(a) for a in topo.get_hybrid_group_names()],
           "expert_ranks": hcg.get_expert_parallel_group().ranks,
           "data_ranks": hcg.get_data_parallel_group().ranks,
           "ep_rank": hcg.get_expert_parallel_rank(),
           "dp_rank": hcg.get_data_parallel_rank(),
           "indices": [list(b) for b in sampler],
           "event": " ".join(e for e in events if "fleet/init" in e)}
    fleet.fleet._reset()
    return out


def ep_refusals():
    """The refusals that remain at ep > 1, each as (type, message) or
    None where it is taken: ``T % ep``, ``E % ep``, ep x sep
    (``MoELayer``), ep x ZeRO (``fleet.init``) and a ``generate`` step of
    a MoE model built at ep > 1."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    n = env.get_world_size()
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))

    _fleet({"ep_degree": n, "dp_degree": 1})
    layer = MoELayer(8, 16, 4 * n, device="cpu")
    attempt("tokens", lambda: layer(torch.zeros(n + 1, 8)))
    attempt("experts", lambda: MoELayer(8, 16, 4 * n + 1, device="cpu"))
    model = Qwen2MoeForCausalLM(Qwen2MoeConfig.tiny(), device="cpu")
    attempt("generate", lambda: model.generate(
        torch.zeros(1, 4, dtype=torch.int64), max_new_tokens=2,
        decode_strategy="greedy_search"))
    if n % 4 == 0:
        _fleet({"ep_degree": 2, "sep_degree": n // 2, "dp_degree": 1})
        attempt("sep", lambda: MoELayer(8, 16, 8, device="cpu"))
    attempt("zero", lambda: _fleet({"ep_degree": 2, "sharding_degree":
                                    n // 2, "dp_degree": 1}))
    fleet.fleet._reset()
    return out


# ---- the models ---------------------------------------------------------------

def _family(name):
    from paddle_tpu_torch.models import deepseek, qwen2
    return {"qwen2_moe": (qwen2.Qwen2MoeConfig, qwen2.Qwen2MoeForCausalLM),
            "deepseek": (deepseek.DeepseekV2Config,
                         deepseek.DeepseekV2ForCausalLM)}[name]


def set_capacity(model, cf):
    """Every MoE layer's gate at capacity factor ``cf`` (DeepSeek's config
    has no field for it)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    for m in model.modules():
        if isinstance(m, MoELayer):
            m.gate.capacity_factor = cf


def bank_state(model, opt):
    """{bank name: (its shape, its optimizer slots' shapes)} of this
    rank."""
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        base_optimizer
    base = base_optimizer(opt)
    state = base.state_dict()
    out = {}
    for name, p in model.named_parameters():
        if name.endswith(("w_gate", "w_up", "w_down")):
            key = base._param_key(p) + "_"
            slots = {k.removeprefix(key): tuple(v.shape)
                     for k, v in state.items()
                     if k.startswith(key) and v.dim() > 0}
            out[name] = (tuple(p.shape), slots)
    return out


def ep_train(family, fields, arrays, batches, hybrid, opt_name="adamw",
             lr=1e-3, wd=0.01, clip=None, cf=None, save=None, load=None,
             device="cpu"):
    """A tiny ``family`` model (``tiny()`` with ``fields``, tensor
    parallel) from the JAX weights ``arrays`` under ``fleet.init(hybrid)``
    through ``fleet.distributed_model``/``distributed_optimizer``, one
    step a global batch, each rank on its data replica's rows (the ranks
    of an ``expert`` group read the same rows). ``cf`` sets every MoE
    layer's capacity factor. With ``load`` the model and optimizer first
    resume that checkpoint (``hapi.Model.load_checkpoint``); with
    ``save`` they are saved before the last step. Returns the losses,
    the first step's gradients, the global norms the clip saw, the final
    weights (rank 0), each bank's and its optimizer state's shapes on
    this rank, the data replica and the step count after the load."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import (
        HybridParallelClipGrad, base_optimizer)
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import data_replicas
    from torch_cp_cases import _optimizer
    hcg = _fleet(hybrid)
    cfg_cls, model_cls = _family(family)
    cfg = dataclasses.replace(cfg_cls.tiny(), tensor_parallel=True,
                              **fields)
    dev = device or env.current_device()
    model = model_cls(cfg, device=dev, seed=3)
    if cf is not None:
        set_capacity(model, cf)
    convert.from_numpy_state_dict(model, arrays, hcg=hcg)
    model.train()
    opt = _optimizer(opt_name, model.parameters(), lr, wd, clip)
    net = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    step0 = None
    if load is not None:
        m = Model(model)
        m.prepare(opt)
        m.load_checkpoint(load)
        step0 = base_optimizer(opt)._step_count
    n_rep, rep = data_replicas()
    clipper = base_optimizer(opt)._grad_clip
    losses, grads0, norms = [], None, []
    for step, ids in enumerate(batches):
        if save is not None and step == len(batches) - 1:
            m = Model(model)
            m.prepare(opt)
            m.save_checkpoint(save, epoch=0)
        rows = ids.shape[0] // n_rep
        t = torch.from_numpy(ids[rep * rows:(rep + 1) * rows]).to(dev)
        _, loss = net(t, labels=t)
        loss.backward()
        if step == 0:
            grads0 = convert.grads_to_numpy(model)
        if isinstance(clipper, HybridParallelClipGrad):
            norms.append(float(clipper.global_norm(
                [(p, p.grad) for p in model.parameters()])))
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    weights = convert.to_numpy_state_dict(model)
    top = env.get_rank() == 0
    banks = bank_state(model, opt)
    fleet.fleet._reset()
    return {"losses": losses, "grads0": grads0,
            "norms": norms, "weights": weights if top else None,
            "banks": banks, "rep": rep, "step0": step0}


def ep_fit(arrays, ids, hybrid, path, cf):
    """``hapi.Model.fit`` of the tiny Qwen2-MoE (aux loss folded out, the
    capacity factor ``cf``) under ``fleet.init(hybrid)``: two epochs
    uninterrupted, then from the same weights one epoch saved into
    ``path`` (``save_dir``) and a model from another seed resumed there
    (``resume=True``) for the second. Returns each run's epoch mean
    losses, the resumed run's epochs and step count."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import (Qwen2MoeConfig, Qwen2MoeForCausalLM,
                                         Qwen2MoePretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    _fleet(hybrid)
    cfg = dataclasses.replace(Qwen2MoeConfig.tiny(), capacity_factor=cf,
                              router_aux_loss_coef=0.0)
    t = torch.from_numpy(ids)
    data = TensorDataset([t, t])

    def run(epochs, seed, load=True, **kw):
        model = Qwen2MoeForCausalLM(cfg, device="cpu", seed=seed)
        if load:
            convert.from_numpy_state_dict(model, arrays)
        m = Model(model)
        m.prepare(AdamW(learning_rate=1e-3, parameters=model.parameters(),
                        weight_decay=0.01), Qwen2MoePretrainingCriterion(cfg))
        m.fit(data, batch_size=2, epochs=epochs, verbose=0, shuffle=False,
              compiled=False, **kw)
        return m, [s["mean_loss"] for s in m._epoch_summaries]

    _, whole = run(2, 3)
    _, first = run(1, 3, save_dir=path)
    m, resumed = run(2, 77, load=False, save_dir=path, resume=True)
    out = {"whole": whole, "first": first, "resumed": resumed,
           "epochs": [s["epoch"] for s in m._epoch_summaries],
           "step": m._optimizer._step_count}
    fleet.fleet._reset()
    return out
