"""What the ranks of ``torch_dist_pool.RankPool`` run for the pipeline
tests (``tests/test_torch_pipeline.py``): each function runs on every
rank and returns numpy arrays or plain values; the tests hold them
against the JAX package. Imports torch and ``paddle_tpu_torch`` only."""

from __future__ import annotations

import dataclasses

import torch

from paddle_tpu_torch.distributed import env


def pipe_fleet(hybrid, pipeline=None, sharding_stage=None):
    """``fleet.init`` with ``hybrid`` degrees and ``pipeline`` configs."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(hybrid)
    s.pipeline_configs.update(pipeline or {})
    if sharding_stage:
        s.sharding_configs = {"stage": sharding_stage}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _pipe_model(family, fields, device="cpu", seed=0, dtype=torch.float32,
                **kw):
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLMPipe,
                                         Qwen2MoeConfig,
                                         Qwen2MoeForCausalLMPipe)
    if family == "llama":
        cfg = dataclasses.replace(LlamaConfig.tiny(), tensor_parallel=True,
                                  **fields)
        return LlamaForCausalLMPipe(cfg, device=device, dtype=dtype,
                                    seed=seed, **kw)
    cfg = dataclasses.replace(Qwen2MoeConfig.tiny(), tensor_parallel=True,
                              **fields)
    return Qwen2MoeForCausalLMPipe(cfg, device=device, dtype=dtype,
                                   seed=seed, **kw)


def pipe_train(family, fields, arrays, batches, hybrid, pipeline, lr=1e-3,
               wd=0.01, clip=None, sharding_stage=None, device="cpu"):
    """A tiny ``family`` pipe model from the JAX weights ``arrays`` (the
    unpartitioned model's keys) under ``fleet.init(hybrid, pipeline)``,
    through ``fleet.distributed_model``/``distributed_optimizer`` (AdamW),
    one step a global batch, each rank on its data replica's rows: the
    first step through ``forward_backward_pipeline`` (its gradients
    gathered before the update) and ``_optimizer_step``, the others
    through ``train_batch``; ``eval_batch`` before the first. Returns the
    losses, the eval loss, the first gradients, the final weights (rank
    0), the replica, this rank's parameter count, ``parameters_by_stage``'s
    counts, the table's bound, the peak of live microbatch graphs and the
    MoE banks' and their optimizer state's shapes on this rank."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.io import data_replicas
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.clip import ClipGradByGlobalNorm
    hcg = pipe_fleet(hybrid, pipeline, sharding_stage)
    layer = _pipe_model(family, fields, device,
                        seed=1)  # another seed: the JAX weights replace it
    convert.from_numpy_state_dict(layer, arrays, hcg=hcg)
    opt = AdamW(learning_rate=lr, parameters=layer.parameters(),
                weight_decay=wd,
                grad_clip=None if clip is None else
                ClipGradByGlobalNorm(clip))
    model = fleet.distributed_model(layer)
    opt = fleet.distributed_optimizer(opt)
    n_rep, rep = data_replicas()
    losses, grads0, peaks = [], None, []

    def local(ids):
        rows = ids.shape[0] // n_rep
        return torch.from_numpy(ids[rep * rows:(rep + 1) * rows])

    t = local(batches[0])
    eval_loss = float(model.eval_batch((t, t)))
    for step, ids in enumerate(batches):
        t = local(ids)
        if step == 0:
            loss = model.forward_backward_pipeline((t, t))
            if hcg.get_sharding_parallel_world_size() == 1:
                grads0 = convert.grads_to_numpy(layer)
            model._optimizer_step(opt)
        else:
            loss = model.train_batch((t, t), opt)
        losses.append(float(loss))
        peaks.append(model.peak_live)
    weights = convert.to_numpy_state_dict(layer)
    by_stage = [int(sum(p.numel() for p in ps))
                for ps in layer.parameters_by_stage]
    M = model.accumulate_steps
    from torch_ep_cases import bank_state
    return {"losses": losses, "eval": eval_loss, "grads0": grads0,
            "weights": weights if env.get_rank() == 0 else None,
            "rep": rep, "stage": hcg.get_stage_id(),
            "param_numel": int(sum(p.numel() for p in layer.parameters())),
            "by_stage": by_stage, "peak_live": max(peaks),
            "bound": model._row(M, True)[1],
            "n_layers_held": len(layer.run_function),
            "banks": bank_state(layer, opt)}


def pipe_seed(family, fields, seed, hybrid, pipeline=None):
    """The pipe model from ``seed`` (its own draw), gathered whole, and
    this rank's parameter count beside ``parameters_by_stage``'s."""
    from paddle_tpu_torch import convert
    hcg = pipe_fleet(hybrid, pipeline)
    layer = _pipe_model(family, fields, seed=seed)
    weights = convert.to_numpy_state_dict(layer)     # every rank gathers
    return {"weights": weights if env.get_rank() == 0 else None,
            "stage": hcg.get_stage_id(),
            "held": sorted(int(k) for k in layer.run_function),
            "param_numel": int(sum(p.numel() for p in layer.parameters())),
            "by_stage": [int(sum(p.numel() for p in ps))
                         for ps in layer.parameters_by_stage]}


# ---- a tied embedding and head (SharedLayerDesc) ------------------------------

class TiedEmbedding(torch.nn.Module):
    def __init__(self, vocab, dim, device=None):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(vocab, dim,
                                                     device=device))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Block(torch.nn.Module):
    def __init__(self, dim, device=None):
        super().__init__()
        self.fc = torch.nn.Linear(dim, dim, device=device)

    def forward(self, x):
        return x + torch.tanh(self.fc(x))


def tied_head(layer, x):
    return x @ layer.weight.t()


def token_ce(logits, labels):
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def shared_train(arrays, batches, hybrid, pipeline, vocab, dim, n_blocks,
                 lr=1e-2):
    """A PipelineLayer of a tied embedding (``SharedLayerDesc`` on the
    first and the last stage) around ``n_blocks`` blocks, from the JAX
    weights ``arrays``, through AdamW steps: the losses, the weights
    gathered and the tied weight's holders."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.optimizer import AdamW
    pipe_fleet(hybrid, pipeline)
    descs = [SharedLayerDesc("emb", TiedEmbedding, None, "weight", vocab,
                             dim)] + \
        [LayerDesc(Block, dim) for _ in range(n_blocks)] + \
        [SharedLayerDesc("emb", TiedEmbedding, tied_head, "weight", vocab,
                         dim)]
    layer = PipelineLayer(descs, loss_fn=token_ce, device="cpu")
    convert.from_numpy_state_dict(layer, arrays)
    opt = fleet.distributed_optimizer(AdamW(learning_rate=lr,
                                            parameters=layer.parameters()))
    model = fleet.distributed_model(layer)
    losses = []
    for ids in batches:
        t = torch.from_numpy(ids)
        losses.append(float(model.train_batch((t, t), opt)))
    dup = [bool(getattr(p, "pipe_duplicate", False))
           for p in layer.parameters()]
    return {"losses": losses, "weights": convert.to_numpy_state_dict(layer),
            "holds_tied": "0" in layer.run_function, "dup": dup}


# ---- checkpoints ------------------------------------------------------------

def pipe_ckpt_save(arrays, batches, hybrid, pipeline, path, fields=None):
    """The tiny Llama pipe model from ``arrays`` through
    ``len(batches) - 1`` AdamW steps, saved (``hapi.Model.
    save_checkpoint``: each stage its own layers and optimizer state),
    then one step more: the losses and the bytes this rank wrote."""
    import json
    import os

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import data_replicas
    from paddle_tpu_torch.optimizer import AdamW
    hcg = pipe_fleet(hybrid, pipeline)
    layer = _pipe_model("llama", fields or {}, seed=1)
    convert.from_numpy_state_dict(layer, arrays, hcg=hcg)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, parameters=layer.parameters(),
        weight_decay=0.01))
    model = fleet.distributed_model(layer)
    n_rep, rep = data_replicas()
    losses = []
    for i, ids in enumerate(batches):
        if i == len(batches) - 1:
            m = Model(layer)
            m.prepare(opt)
            m.save_checkpoint(path, epoch=0)
        rows = ids.shape[0] // n_rep
        t = torch.from_numpy(ids[rep * rows:(rep + 1) * rows])
        losses.append(float(model.train_batch((t, t), opt)))
    with open(os.path.join(path, f"meta.{env.get_rank()}.json")) as f:
        meta = json.load(f)
    nbytes = sum(sh["nbytes"] for e in meta.values()
                 if e.get("kind") == "tensor" for sh in e["shards"])
    return {"losses": losses, "bytes": nbytes, "rep": rep}


def pipe_ckpt_resume(batches, hybrid, pipeline, path, fields=None):
    """The tiny Llama pipe model from another seed, ``hapi.Model.
    load_checkpoint(path)``, then a step on each of ``batches``: the
    losses and the optimizer's step count after the load."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    pipe_fleet(hybrid, pipeline)
    layer = _pipe_model("llama", fields or {}, seed=9)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, parameters=layer.parameters(),
        weight_decay=0.01))
    model = fleet.distributed_model(layer)
    m = Model(layer)
    m.prepare(opt)
    m.load_checkpoint(path)
    step0 = opt._step_count
    losses = []
    for ids in batches:
        t = torch.from_numpy(ids)
        losses.append(float(model.train_batch((t, t), opt)))
    return {"losses": losses, "step0": step0}


# ---- refusals ----------------------------------------------------------------

def pipe_errors():
    """Each refusal's type and message: an unknown schedule, interleaved
    without virtual stages, an explicit schedule with them, a virtual
    count that conflicts with the layer's, pp with sep beyond the world
    (pp x sep is taken where the ranks make it), pp with ep, degrees that
    do not make the world, ZeRO 3 under pp."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.optimizer import AdamW
    n = env.get_world_size()
    out = {}

    def attempt(name, fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
        else:
            out[name] = None

    def wrap(pipeline, **kw):
        def go():
            pipe_fleet({"pp_degree": n, "dp_degree": 1}, pipeline)
            fleet.distributed_model(_pipe_model(
                "llama", {"num_hidden_layers": 4}, **kw))
        return go

    attempt("unknown", wrap({"schedule_mode": "2F2B"}))
    attempt("interleaved_no_v", wrap({"schedule_mode": "interleaved"}))
    attempt("explicit_with_v", wrap({"schedule_mode": "1F1B",
                                      "num_virtual_pipeline_stages": 2}))
    attempt("conflicting_v", wrap({"schedule_mode": "interleaved",
                                   "num_virtual_pipeline_stages": 2},
                                  num_virtual_pipeline_stages=4))
    attempt("sep", lambda: pipe_fleet({"pp_degree": 2, "sep_degree": 2,
                                       "dp_degree": -1}))
    attempt("ep", lambda: pipe_fleet({"pp_degree": 2, "ep_degree": 2,
                                      "dp_degree": -1}))    # 4 ranks
    attempt("degrees", lambda: pipe_fleet({"pp_degree": 2, "mp_degree": 2,
                                           "dp_degree": 2}))

    def zero3():
        pipe_fleet({"pp_degree": n, "dp_degree": 1})
        layer = _pipe_model("llama", {})
        group_sharded_parallel(layer, AdamW(parameters=layer.parameters()),
                               level="p_g_os")
    attempt("zero3", zero3)
    fleet.fleet._reset()
    return out


# ---- the card ------------------------------------------------------------------

def card_pipe(fields, arrays, batches, hybrid, pipeline):
    """``pipe_train``'s losses and first gradients on the rank's card."""
    res = pipe_train("llama", fields, arrays, batches, hybrid, pipeline,
                     device=None)
    return {"losses": res["losses"], "grads0": res["grads0"],
            "device": str(env.current_device())}



def pipe_model_save(arrays, batches, hybrid, pipeline, path, fields):
    """``hapi.Model.save`` (the ``.pdparams``/``.pdopt`` files, the whole
    model written by the first rank) after ``len(batches) - 1`` steps of
    the pipe model from ``arrays``; then a fresh pipe model (another
    seed) ``Model.load``s them and both take the last step: the two last
    losses and the gathered weights after the save."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    hcg = pipe_fleet(hybrid, pipeline)
    out = {}
    for seed in (1, 9):
        layer = _pipe_model("llama", fields, seed=seed)
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=1e-3, parameters=layer.parameters(),
            weight_decay=0.01))
        model = fleet.distributed_model(layer)
        m = Model(layer)
        m.prepare(opt)
        if seed == 1:
            convert.from_numpy_state_dict(layer, arrays, hcg=hcg)
            for ids in batches[:-1]:
                t = torch.from_numpy(ids)
                model.train_batch((t, t), opt)
            m.save(path)
            out["weights"] = convert.to_numpy_state_dict(layer)
        else:
            m.load(path)
        t = torch.from_numpy(batches[-1])
        out[seed] = float(model.train_batch((t, t), opt))
    return out
