"""What the ranks of ``torch_dist_pool.RankPool`` run for the context
parallelism tests (``tests/test_torch_context_parallel.py``): each
function runs on every rank and returns numpy arrays or plain values;
the tests hold them against the JAX package. Imports torch and
``paddle_tpu_torch`` only."""

from __future__ import annotations

import dataclasses

import numpy as np
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


def _seq_slice(a, n, r, axis=1):
    per = a.shape[axis] // n
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(r * per, (r + 1) * per)
    return a[tuple(sl)]


# ---- the ops --------------------------------------------------------------------

def op_cases(cases):
    """Each case ``(name, impl, q, k, v, causal, placement, dtype,
    grads)`` over the world as the sep group: this rank's contiguous
    slice of the whole (already reordered) q, k and v through
    ``ops.ring_attention``'s ``impl``; with ``grads`` the gradients of
    the rank's share of ``sum(out * cos(out))`` (the ranks' shares sum to
    the whole loss). Returns {name: (out, dq, dk, dv)} of this rank's
    slice, or {name: ("error", type, message)}."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import ring_attention as ra
    n, r = env.get_world_size(), env.get_rank()
    hcg = _fleet({"sep_degree": n, "dp_degree": 1})
    group = hcg.get_sep_parallel_group()
    out = {}
    for name, impl, q, k, v, causal, placement, dtype, grads in cases:
        dt = getattr(torch, dtype)
        qs, ks, vs = (torch.from_numpy(_seq_slice(a, n, r)).to(dt)
                      .requires_grad_(grads) for a in (q, k, v))
        try:
            if impl == "ring":
                o = ra.ring_attention(qs, ks, vs, group, causal=causal,
                                      placement=placement)
            elif impl == "ulysses":
                o = ra.ulysses_attention(qs, ks, vs, group, causal=causal)
            else:
                o = ra.allgather_attention(qs, ks, vs, group, causal=causal)
        except ValueError as e:
            out[name] = ("error", type(e).__name__, str(e))
            continue
        res = [_np(o), str(o.dtype)]
        if grads:
            (o.float() * torch.cos(o.float())).sum().backward()
            res += [_np(t.grad) for t in (qs, ks, vs)]
        out[name] = tuple(res)
    fleet.fleet._reset()
    return out


def wrappers(q, k, v):
    """The fleet wrappers over the world as the sep group (degree n):
    ``ring_flash_attention``, ``ulysses_attention``, ``sep_attention``
    and ``sep_attention_manual`` (RoPE at the global positions first) of
    each impl on this rank's slice, and ``gather_outputs_sequence_dim``
    of the ring's output (the whole sequence); then, at degree 1 (a
    fleet of data ranks only), the wrappers on the whole sequence."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
    n, r = env.get_world_size(), env.get_rank()
    _fleet({"sep_degree": n, "dp_degree": 1})
    qs, ks, vs = (torch.from_numpy(_seq_slice(a, n, r)) for a in (q, k, v))
    out = {"ring": _np(mp.ring_flash_attention(qs, ks, vs, causal=True)),
           "ulysses": _np(mp.ulysses_attention(qs, ks, vs, causal=True)),
           "is_manual": mp.sep_axis_is_manual()}
    for impl in ("ring", "ulysses", "allgather"):
        out[f"sep_{impl}"] = _np(mp.sep_attention(qs, ks, vs, impl=impl))
    out["gathered"] = _np(mp.gather_outputs_sequence_dim(
        mp.ring_flash_attention(qs, ks, vs, causal=True)))
    out["manual"] = {impl: _np(mp.sep_attention_manual(
        qs, ks, vs, rope_theta=10000.0, impl=impl))
        for impl in ("ring", "ulysses", "allgather")}
    try:
        mp.sep_attention(qs, ks, vs, impl="ulysses", placement="zigzag")
        out["zigzag_refused"] = None
    except ValueError as e:
        out["zigzag_refused"] = str(e)
    out["split"] = mp.split_inputs_sequence_dim(
        np.arange(8 * n).reshape(1, -1))
    _fleet({"dp_degree": n})
    whole = [torch.from_numpy(a) for a in (q, k, v)]
    out["single_ring"] = _np(mp.ring_flash_attention(*whole, causal=True))
    out["single_ulysses"] = _np(mp.ulysses_attention(*whole, causal=True))
    out["single_is_manual"] = mp.sep_axis_is_manual()
    fleet.fleet._reset()
    return out


# ---- the models --------------------------------------------------------------------

def _family(name):
    from paddle_tpu_torch.models import llama, qwen2
    return {"llama": (llama.LlamaConfig, llama.LlamaForCausalLM),
            "qwen2": (qwen2.Qwen2Config, qwen2.Qwen2ForCausalLM),
            "qwen2_moe": (qwen2.Qwen2MoeConfig, qwen2.Qwen2MoeForCausalLM)
            }[name]


def _optimizer(name, params, lr, wd, clip):
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.optimizer.clip import ClipGradByGlobalNorm
    grad_clip = None if clip is None else ClipGradByGlobalNorm(clip)
    if name == "sgd":
        return SGD(learning_rate=lr, parameters=params, grad_clip=grad_clip)
    return AdamW(learning_rate=lr, parameters=params, weight_decay=wd,
                 grad_clip=grad_clip)


def sep_train(family, fields, arrays, batches, hybrid, opt_name="adamw",
              lr=1e-3, wd=0.01, clip=None, save=None, load=None,
              device="cpu"):
    """A tiny ``family`` model (``tiny()`` with ``fields``, tensor
    parallel) from the JAX weights ``arrays`` under ``fleet.init(hybrid)``
    through ``fleet.distributed_model``/``distributed_optimizer``, one
    step a global batch, each rank on its data replica's rows and its sep
    rank's slice of the sequence (``split_inputs_sequence_dim``). With
    ``load`` the model and optimizer first resume that checkpoint; with
    ``save`` they are saved (``hapi.Model.save_checkpoint``) before the
    last step. Returns the losses (the whole sequence's, on every
    rank), the first step's gradients and the global norm the clip saw
    (rank 0), the final weights (rank 0) and the optimizer's step count
    after the load. ``device`` None: the rank's device (the card)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        base_optimizer
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        split_inputs_sequence_dim
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import data_replicas
    hcg = _fleet(hybrid)
    cfg_cls, model_cls = _family(family)
    cfg = dataclasses.replace(cfg_cls.tiny(), tensor_parallel=True,
                              **fields)
    dev = device or env.current_device()
    model = model_cls(cfg, device=dev, seed=3)
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
    norms = []
    clipper = base_optimizer(opt)._grad_clip
    if clipper is not None:
        from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
            HybridParallelClipGrad
        norm_of = clipper.global_norm if isinstance(
            clipper, HybridParallelClipGrad) else None
    losses, grads0 = [], None
    for step, ids in enumerate(batches):
        if save is not None and step == len(batches) - 1:
            m = Model(model)
            m.prepare(opt)
            m.save_checkpoint(save, epoch=0)
        rows = ids.shape[0] // n_rep
        t = split_inputs_sequence_dim(
            torch.from_numpy(ids[rep * rows:(rep + 1) * rows])).to(dev)
        _, loss = net(t, labels=t)
        loss.backward()
        if step == 0:
            grads0 = convert.grads_to_numpy(model)
        if clipper is not None:
            pg = [(p, p.grad) for p in model.parameters()]
            if norm_of is not None:
                norms.append(float(norm_of(pg)))
            else:
                from paddle_tpu_torch.optimizer.clip import _sq_sum
                norms.append(float(sum(_sq_sum(g) for _, g in pg
                                       if g is not None) ** 0.5))
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    weights = convert.to_numpy_state_dict(model)
    top = env.get_rank() == 0
    fleet.fleet._reset()
    return {"losses": losses, "grads0": grads0 if top else None,
            "norms": norms, "weights": weights if top else None,
            "step0": step0, "rep": rep}


def cache_step_refused(fields):
    """A ``generate`` step of a sep model under a sep group raises;
    returns the error's type and message."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    _fleet({"sep_degree": env.get_world_size(), "dp_degree": 1})
    model = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(),
                                                 **fields), device="cpu")
    try:
        model.generate(torch.zeros(1, 4, dtype=torch.int64),
                       max_new_tokens=2, decode_strategy="greedy_search")
        res = None
    except NotImplementedError as e:
        res = (type(e).__name__, str(e))
    fleet.fleet._reset()
    return res


# ---- the pipeline ----------------------------------------------------------------

def sep_pipe_train(family, fields, arrays, batches, hybrid, pipeline,
                   opt_name="adamw", lr=1e-3, wd=0.01):
    """``torch_pipe_cases.pipe_train``'s run with each rank on its sep
    rank's slice of the sequence: the losses (every rank), the first
    step's gradients gathered over the stages (``forward_backward_
    pipeline`` then ``_optimizer_step``) and the final weights (rank
    0)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        split_inputs_sequence_dim
    from paddle_tpu_torch.io import data_replicas
    from torch_pipe_cases import _pipe_model
    hcg = _fleet(hybrid, pipeline)
    layer = _pipe_model(family, fields, "cpu", seed=1)
    convert.from_numpy_state_dict(layer, arrays, hcg=hcg)
    opt = fleet.distributed_optimizer(_optimizer(
        opt_name, layer.parameters(), lr, wd, None))
    model = fleet.distributed_model(layer)
    n_rep, rep = data_replicas()
    losses, grads0 = [], None
    for step, ids in enumerate(batches):
        rows = ids.shape[0] // n_rep
        t = split_inputs_sequence_dim(
            torch.from_numpy(ids[rep * rows:(rep + 1) * rows]))
        if step == 0:
            loss = model.forward_backward_pipeline((t, t))
            grads0 = convert.grads_to_numpy(layer)
            model._optimizer_step(opt)
        else:
            loss = model.train_batch((t, t), opt)
        losses.append(float(loss))
    weights = convert.to_numpy_state_dict(layer)
    top = env.get_rank() == 0
    fleet.fleet._reset()
    return {"losses": losses, "grads0": grads0 if top else None,
            "weights": weights if top else None, "rep": rep}


def pipe_ring_refused(schedules):
    """``fleet.distributed_model`` of a ring ``LlamaForCausalLMPipe`` at
    pp 2 x sep 2 under each of ``schedules``: the error's type and
    message, or None where it is taken."""
    from paddle_tpu_torch.distributed import fleet
    from torch_pipe_cases import _pipe_model
    out = {}
    for schedule in schedules:
        _fleet({"pp_degree": 2, "sep_degree": 2, "dp_degree": 1},
               {"schedule_mode": schedule, "accumulate_steps": 2})
        try:
            fleet.distributed_model(_pipe_model(
                "llama", {"num_hidden_layers": 4, "sep_parallel": "ring"}))
            out[schedule] = None
        except ValueError as e:
            out[schedule] = (type(e).__name__, str(e))
    fleet.fleet._reset()
    return out
