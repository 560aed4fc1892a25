"""What the ranks of ``torch_dist_pool.RankPool`` run for the multi-rank
tests (``tests/test_torch_distributed.py``, ``test_torch_tensor_parallel
.py``, ``test_torch_dp_sharding.py``): each function runs on every rank
and returns numpy arrays or plain values; the tests hold them against the
JAX package. Imports torch and ``paddle_tpu_torch`` only."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed import env


def _np(t):
    return t.detach().float().cpu().numpy()


# ---- collectives ------------------------------------------------------------

def collectives(staged=False):
    """Every collective of ``communication`` on small CPU tensors of
    known values (rank r holds r + 1 ...). ``staged`` runs them through
    the backend rule's host copies (as gloo runs CUDA tensors)."""
    if staged:
        C._staged = lambda g, t: True
    r, n = env.get_rank(), env.get_world_size()
    out = {"rank": r, "world": n, "backend": C.get_backend()}
    x = torch.full((3,), float(r + 1))
    for op in ("sum", "max", "min", "prod", "avg"):
        t = x.clone()
        C.all_reduce(t, op)
        out[f"all_reduce_{op}"] = _np(t)
    # a non-contiguous tensor is reduced in place through a copy
    t = torch.arange(6.0).reshape(2, 3).t() * (r + 1)
    C.all_reduce(t)
    out["all_reduce_strided"] = _np(t)
    out["all_gather"] = [_np(p) for p in C.all_gather([], x * 10)]
    out["all_gather_object"] = C.all_gather_object([], {"r": r})
    src = torch.arange(2.0 * n) + 100 * r
    dst = torch.empty(2)
    C.reduce_scatter(dst, src)
    out["reduce_scatter"] = _np(dst)
    dst = torch.empty(2)
    C.reduce_scatter(dst, list(src.chunk(n)), op="avg")
    out["reduce_scatter_avg"] = _np(dst)
    ins = [torch.full((2,), float(10 * r + j)) for j in range(n)]
    out["alltoall"] = [_np(p) for p in C.alltoall([], ins)]
    # bf16 parts of two rows (their bytes move as they are)
    ins = [torch.full((2, 3), 10 * r + j + 0.5, dtype=torch.bfloat16)
           for j in range(n)]
    got_bf16 = C.alltoall([], ins)
    out["alltoall_bf16"] = [(str(p.dtype), tuple(p.shape), _np(p))
                            for p in got_bf16]
    single = torch.arange(float(n)) + 10 * r
    got = torch.empty(n)
    C.alltoall_single(got, single)
    out["alltoall_single"] = _np(got)
    # uneven splits: rank r sends j + 1 rows to rank j
    rows = sum(j + 1 for j in range(n))
    uneven = torch.arange(float(rows)) + 100 * r
    got = torch.empty(n * (r + 1))
    C.alltoall_single(got, uneven, in_split_sizes=[j + 1 for j in range(n)],
                      out_split_sizes=[r + 1] * n)
    out["alltoall_uneven"] = _np(got)
    t = torch.full((2,), float(r))
    C.broadcast(t, src=n - 1)
    out["broadcast"] = _np(t)
    objs = [f"from{r}", r]
    C.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    t = torch.full((2,), float(r + 1))
    C.reduce(t, dst=0)
    out["reduce"] = _np(t)
    t = torch.empty(2)
    C.scatter(t, [torch.full((2,), float(j)) for j in range(n)]
              if r == 0 else None, src=0)
    out["scatter"] = _np(t)
    out["gather"] = [_np(p) for p in C.gather(torch.full((1,), float(r)),
                                                None, dst=0)]
    got = []
    C.scatter_object_list(got, [f"s{j}" for j in range(n)] if r == 0
                          else None, src=0)
    out["scatter_object_list"] = got
    # point to point in a ring: send to r + 1, receive from r - 1
    t = torch.full((2,), float(r))
    recv = torch.empty(2)
    if r % 2 == 0:
        C.send(t, dst=(r + 1) % n)
        C.recv(recv, src=(r - 1) % n)
    else:
        C.recv(recv, src=(r - 1) % n)
        C.send(t, dst=(r + 1) % n)
    out["sendrecv"] = _np(recv)
    recv = torch.empty(2)
    works = C.batch_isend_irecv([
        C.P2POp(C.isend, t * 2, (r + 1) % n),
        C.P2POp(C.irecv, recv, (r - 1) % n)])
    for w in works:
        w.wait()
    out["batch_p2p"] = _np(recv)
    # a subgroup of the even ranks: only they call into it
    g = C.new_group([k for k in range(n) if k % 2 == 0])
    if r % 2 == 0:
        t = torch.full((1,), float(r))
        C.all_reduce(t, group=g)
        out["subgroup"] = _np(t)
        out["subgroup_rank"] = g.rank
    else:
        out["subgroup_rank"] = g.rank
    C.barrier()
    return out


def low_precision_collectives(device="cpu"):
    """bf16/f16 ``all_reduce`` (sum, avg) over the two ranks, on
    contiguous and strided tensors (on ``device``), beside the f32 sum of
    the widened values rounded once (the widened path's bits), a
    ``broadcast`` from rank 1 and an ``alltoall`` moving the bytes as
    they are. Returns
    {case: (got, want)} as f32 numpy."""
    r = env.get_rank()
    gen = torch.Generator().manual_seed(11 + r)
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        x = (torch.randn(3, 7, generator=gen) * 100).to(dtype).to(device)
        for op in ("sum", "avg"):
            for tag, t in (("contiguous", x.clone()),
                           ("strided", x.clone().t())):
                want = t.float()
                C.all_reduce(want, op)
                C.all_reduce(t, op)
                out[f"{op} {tag} {dtype}"] = (_np(t), _np(want.to(dtype)))
        t = x.clone()
        C.broadcast(t, src=1)
        out[f"broadcast {dtype}"] = (_np(t), _np(C.all_gather([], x)[1]))
        # the all-to-all exchanges the parts' bytes: rank k's part r
        parts = [x * (j + 1) for j in range(2)]
        cols = [C.all_gather([], p) for p in parts]
        for k, got in enumerate(C.alltoall([], parts)):
            out[f"alltoall {dtype} from {k}"] = (_np(got), _np(cols[r][k]))
    return out


def fleet_degrees(configs):
    """``fleet.init`` over each of ``configs`` (hybrid_configs dicts):
    the degrees and this rank's coordinates, or the error's type and
    message."""
    from paddle_tpu_torch.distributed import fleet
    res = []
    for hc in configs:
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(hc)
        try:
            fleet.init(is_collective=True, strategy=s)
        except (ValueError, NotImplementedError) as e:
            res.append(("error", type(e).__name__, str(e)))
            continue
        hcg = fleet.get_hybrid_communicate_group()
        topo = hcg.topology()
        res.append(("ok", [topo.get_dim(a) for a in
                           topo.get_hybrid_group_names()],
                    topo.get_coord(env.get_rank()),
                    {a: hcg._groups[a].ranks
                     for a in topo.get_hybrid_group_names()},
                    hcg.get_parallel_mode()))
    return res


def _fleet(hybrid):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(hybrid)
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _gather(t, dim, group):
    from paddle_tpu_torch.distributed.parallel_layers import _all_gather
    return _np(_all_gather(t.detach(), dim, group))


# ---- tensor-parallel layers ---------------------------------------------------

def tp_layers(a, device="cpu"):
    """Each TP layer forward and backward at the model group of the whole
    world, from the full weights in ``a`` (Paddle's [in, out] layout), on
    ``device``: outputs, input grads and each weight's grad gathered to
    full shape ([in, out] again for the linears)."""
    from paddle_tpu_torch.distributed import parallel_layers as pl
    hcg = _fleet({"mp_degree": env.get_world_size()})
    g = hcg.get_model_parallel_group()
    dev = dict(device=device)
    a = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
    out = {}

    def load(layer, name, full):
        with torch.no_grad():
            getattr(layer, name).copy_(pl.shard_of(layer, name, full))

    x = a["x"].clone().requires_grad_()
    # column, gathered output
    col = pl.ColumnParallelLinear(8, 12, gather_output=True, **dev)
    load(col, "weight", a["w1"].T)
    load(col, "bias", a["b1"])
    y = col(x)
    (y * a["dy1"]).sum().backward()
    out["col_y"], out["col_dx"] = _np(y), _np(x.grad)
    out["col_dw"] = _gather(col.weight.grad, 0, g).T
    out["col_db"] = _gather(col.bias.grad, 0, g)
    # column (split output) into row (parallel input)
    x.grad = None
    colp = pl.ColumnParallelLinear(8, 12, gather_output=False, **dev)
    load(colp, "weight", a["w1"].T)
    load(colp, "bias", a["b1"])
    rowp = pl.RowParallelLinear(12, 8, input_is_parallel=True, **dev)
    load(rowp, "weight", a["w2"].T)
    load(rowp, "bias", a["b2"])
    y = rowp(colp(x))
    (y * a["dy2"]).sum().backward()
    out["mlp_y"], out["mlp_dx"] = _np(y), _np(x.grad)
    out["mlp_dw1"] = _gather(colp.weight.grad, 0, g).T
    out["mlp_db1"] = _gather(colp.bias.grad, 0, g)
    out["mlp_dw2"] = _gather(rowp.weight.grad, 1, g).T
    out["mlp_db2"] = _np(rowp.bias.grad)
    # row over a whole input (split here)
    h = a["h"].clone().requires_grad_()
    row = pl.RowParallelLinear(12, 8, input_is_parallel=False,
                               has_bias=False, **dev)
    load(row, "weight", a["w2"].T)
    y = row(h)
    (y * a["dy2"]).sum().backward()
    out["row_y"], out["row_dh"] = _np(y), _np(h.grad)
    out["row_dw"] = _gather(row.weight.grad, 1, g).T
    # the vocab-parallel embedding
    emb = pl.VocabParallelEmbedding(16, 8, **dev)
    load(emb, "weight", a["emb"])
    e = emb(a["ids"])
    (e * a["dy1"][..., :8]).sum().backward()
    out["emb_y"] = _np(e)
    out["emb_dw"] = _gather(emb.weight.grad, 0, g)
    # the parallel cross entropy over vocab-split logits
    full = a["logits"]
    per = full.shape[-1] // g.nranks
    local = full[..., g.rank * per:(g.rank + 1) * per].clone() \
        .requires_grad_()
    loss = pl.ParallelCrossEntropy()(local, a["labels"])
    loss.sum().backward()
    out["pce_loss"] = _np(loss)
    out["pce_dlogits"] = _gather(local.grad, -1, g)
    # split(): a column linear made for the call, gathered
    torch.manual_seed(0)
    out["split_shape"] = tuple(pl.split(x.detach(), (8, 12), "linear",
                                        axis=1, num_partitions=g.nranks)
                               .shape)
    return out


def vocab_parallel_ce(a, chunk_v, device="cpu", dtype="float32"):
    """The vocab-parallel fused linear+CE over this rank's columns of
    ``a["w"]`` [D, V] on ``device`` in ``dtype``: loss, dh (whole on
    every rank), dW gathered, and K10/K11's launches (0 on the CPU)."""
    from paddle_tpu_torch.ops import fused_ce
    from paddle_tpu_torch.ops.kernels import ce_chunk
    hcg = _fleet({"mp_degree": env.get_world_size()})
    g = hcg.get_model_parallel_group()
    dt = getattr(torch, dtype)
    w = torch.from_numpy(a["w"]).to(device, dt)
    per = w.shape[1] // g.nranks
    wl = w[:, g.rank * per:(g.rank + 1) * per].clone().requires_grad_()
    h = torch.from_numpy(a["h"]).to(device, dt).requires_grad_()
    before = ce_chunk.chunk_stats.launches, ce_chunk.chunk_dlogits.launches
    with fused_ce.force_chunk_v(chunk_v):
        loss = fused_ce.fused_linear_cross_entropy(
            h, wl, torch.from_numpy(a["labels"]).to(device), group=g,
            vocab_start=g.rank * per)
        loss.backward()
    return {"loss": loss.item(), "dh": _np(h.grad),
            "dw": _gather(wl.grad, 1, g),
            "launches": (ce_chunk.chunk_stats.launches - before[0],
                         ce_chunk.chunk_dlogits.launches - before[1])}


# ---- models -------------------------------------------------------------------

def _family(name):
    from paddle_tpu_torch.models import deepseek, llama, qwen2
    return {"llama": (llama.LlamaConfig, llama.LlamaForCausalLM),
            "qwen2": (qwen2.Qwen2Config, qwen2.Qwen2ForCausalLM),
            "deepseek": (deepseek.DeepseekV2Config,
                         deepseek.DeepseekV2ForCausalLM)}[name]


def train_steps(family, fields, arrays, batches, hybrid, lr=1e-3, wd=0.01,
                clip=None, zero=None, flag_values=None, micro=1):
    """A tiny ``family`` model (``tiny()`` with ``fields``, tensor
    parallel) from the JAX weights ``arrays`` under ``fleet.init(hybrid)``
    through AdamW steps, one a global batch of ``batches``, each rank on
    its data replica's rows: ``fleet.distributed_model`` /
    ``distributed_optimizer``, or ``group_sharded_parallel(level=zero)``.
    ``micro`` > 1 splits a rank's rows into micro-batches, all but the
    last backward under ``no_sync``. Returns the local losses, the first
    step's gradients gathered (before the optimizer, mp-only runs), the
    final weights gathered, the replica and the optimizer state's size on
    this rank."""
    import dataclasses

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        base_optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.io import data_replicas
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.clip import ClipGradByGlobalNorm
    hcg = _fleet(hybrid)
    if flag_values:
        flags.set_flags(flag_values)
    cfg_cls, model_cls = _family(family)
    cfg = dataclasses.replace(cfg_cls.tiny(), tensor_parallel=True,
                              **fields)
    model = model_cls(cfg, device="cpu")
    convert.from_numpy_state_dict(model, arrays, hcg=hcg)
    model.train()
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=wd,
                grad_clip=None if clip is None else
                ClipGradByGlobalNorm(clip))
    if zero:
        model, opt, _ = group_sharded_parallel(model, opt, level=zero)
    else:
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    n_rep, rep = data_replicas()
    losses, grads0 = [], None
    for step, ids in enumerate(batches):
        rows = ids.shape[0] // n_rep
        local = torch.from_numpy(ids[rep * rows:(rep + 1) * rows])
        parts = local.chunk(micro)
        total = 0.0
        for i, t in enumerate(parts):
            sync = i == len(parts) - 1
            with contextlib.nullcontext() if sync else model.no_sync():
                _, loss = model(t, labels=t)
                (loss / len(parts)).backward()
            total += loss.item() / len(parts)
        if step == 0 and not zero and hcg.get_sharding_parallel_world_size() \
                == 1:
            grads0 = convert.grads_to_numpy(model)
        opt.step()
        opt.clear_grad()
        losses.append(total)
    state = base_optimizer(opt).state_dict()
    sizes = sum(v.numel() for v in state.values()
                if isinstance(v, torch.Tensor) and v.dim() > 0)
    weights = convert.to_numpy_state_dict(model)
    out = {"losses": losses, "grads0": grads0, "rep": rep,
           "n_rep": n_rep, "state_numel": int(sizes),
           "param_numel": int(sum(p.numel() for p in model.parameters())),
           "weights": weights if env.get_rank() == 0 else None}
    if flag_values:
        flags.set_flags({k: flags._registry[k]["default"]
                         for k in flag_values})
    return out


def world_one(family, fields, ids):
    """At world size 1: a model built under ``fleet.init`` (all degrees
    1) and trained two AdamW steps through ``distributed_model`` /
    ``distributed_optimizer`` against the same model built and trained
    without a fleet: True when the losses, logits and weights are equal
    bit for bit."""
    import dataclasses

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    cfg_cls, model_cls = _family(family)
    cfg = dataclasses.replace(cfg_cls.tiny(), tensor_parallel=True,
                              **fields)
    t = torch.from_numpy(ids)

    def run(wrap):
        model = model_cls(cfg, device="cpu", seed=3)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        if wrap:
            model = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
        losses = []
        for _ in range(2):
            _, loss = model(t, labels=t)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
        return losses, model(t).detach(), [p.detach().clone()
                                           for p in model.parameters()]

    plain = run(False)
    _fleet({"mp_degree": 1, "dp_degree": 1})
    wrapped = run(True)
    fleet.fleet._reset()
    same = all(torch.equal(a, b) for a, b in zip(plain[0], wrapped[0]))
    same &= torch.equal(plain[1], wrapped[1])
    same &= all(torch.equal(a, b) for a, b in zip(plain[2], wrapped[2]))
    return same


def sampler_defaults(hybrid, n_items):
    """``io.DistributedBatchSampler``'s replicas and rank with no
    arguments, and the indices of its first epoch, under ``hybrid``."""
    from paddle_tpu_torch import io
    _fleet(hybrid)
    s = io.DistributedBatchSampler(list(range(n_items)), batch_size=2)
    return s.nranks, s.local_rank, [list(b) for b in s]


def parallelized_mlp(a):
    """``distributed.parallelize`` over a two-layer MLP with the plan
    ``{"fc1": ColWiseParallel(), "fc2": RowWiseParallel()}`` at the model
    group of the whole world: the output and the gradients gathered."""
    from torch import nn

    from paddle_tpu_torch.distributed import (ColWiseParallel,
                                              RowWiseParallel, parallelize)
    hcg = _fleet({"mp_degree": env.get_world_size()})
    g = hcg.get_model_parallel_group()

    class MLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 12)
            self.fc2 = nn.Linear(12, 8)

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    net = MLP()
    with torch.no_grad():
        net.fc1.weight.copy_(torch.from_numpy(a["w1"].T.copy()))
        net.fc1.bias.copy_(torch.from_numpy(a["b1"]))
        net.fc2.weight.copy_(torch.from_numpy(a["w2"].T.copy()))
        net.fc2.bias.copy_(torch.from_numpy(a["b2"]))
    net, _ = parallelize(net, config={"mp_config": {"parallelize_plan": {
        "fc1": ColWiseParallel(), "fc2": RowWiseParallel()}}})
    y = net(torch.from_numpy(a["x"]))
    (y * torch.from_numpy(a["dy2"])).sum().backward()
    return {"y": _np(y), "types": [type(net.fc1).__name__,
                                   type(net.fc2).__name__],
            "dw1": _gather(net.fc1.weight.grad, 0, g).T,
            "dw2": _gather(net.fc2.weight.grad, 1, g).T,
            "db2": _np(net.fc2.bias.grad)}


def spawned_rank(path, fail_rank=-1):
    """What ``distributed.spawn`` runs on each rank: join, all-reduce the
    rank, write the sum to ``path.<rank>``; ``fail_rank`` exits 3."""
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env(device="cpu")
    if dist.get_rank() == fail_rank:
        raise SystemExit(3)
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    with open(f"{path}.{dist.get_rank()}", "w") as f:
        f.write(f"{dist.get_world_size()} {t.item()}")


def sharded_save(arrays, batch, level, out_dir):
    """One AdamW step of tiny Llama under ``group_sharded_parallel(level)``
    at the sharding group of the whole world, then
    ``save_group_sharded_model``; returns the files the first rank
    wrote."""
    import os

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.io import data_replicas
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    _fleet({"sharding_degree": env.get_world_size(), "dp_degree": 1})
    model = convert.from_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), arrays)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    model, opt, _ = group_sharded_parallel(model, opt, level=level)
    n, r = data_replicas()
    rows = batch.shape[0] // n
    t = torch.from_numpy(batch[r * rows:(r + 1) * rows])
    _, loss = model(t, labels=t)
    loss.backward()
    opt.step()
    opt.clear_grad()
    save_group_sharded_model(model, out_dir, opt)
    return sorted(os.listdir(out_dir)) if env.get_rank() == 0 else None


def zero3_recompute_refused():
    """Stage 3 over a model that recomputes inside: the refusal's
    message."""
    import dataclasses

    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    _fleet({"sharding_degree": env.get_world_size(), "dp_degree": 1})
    model = LlamaForCausalLM(dataclasses.replace(
        LlamaConfig.tiny(), use_recompute=True), device="cpu")
    model, _, _ = group_sharded_parallel(
        model, AdamW(parameters=model.parameters()), level="p_g_os")
    ids = torch.zeros(1, 4, dtype=torch.long)
    try:
        model(ids, labels=ids)
    except NotImplementedError as e:
        return str(e)
    return None


def clip_global_norm(arrays, batch):
    """Tiny Llama at mp = world from the JAX weights ``arrays``: the
    global gradient norm ``HybridParallelClipGrad`` computes over the
    shards after one backward on ``batch``."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        HybridParallelClipGrad
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer.clip import ClipGradByGlobalNorm
    import dataclasses
    hcg = _fleet({"mp_degree": env.get_world_size()})
    model = LlamaForCausalLM(dataclasses.replace(
        LlamaConfig.tiny(), tensor_parallel=True), device="cpu")
    convert.from_numpy_state_dict(model, arrays, hcg=hcg)
    t = torch.from_numpy(batch)
    _, loss = model(t, labels=t)
    loss.backward()
    clip = HybridParallelClipGrad(ClipGradByGlobalNorm(1.0),
                                  mp_group=hcg.get_model_parallel_group())
    return float(clip.global_norm([(p, p.grad)
                                   for p in model.parameters()]))
