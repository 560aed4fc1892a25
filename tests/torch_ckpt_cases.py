"""What the ranks of ``torch_dist_pool.RankPool`` run for the multi-rank
checkpoint tests (``tests/test_torch_reshard.py``,
``test_torch_dist_checkpoint.py``, ``test_torch_preempt_fit.py``): each
function runs on every rank and returns numpy arrays or plain values; the
tests hold them against the JAX package. Imports torch and
``paddle_tpu_torch`` only.

Tensors travel as ``(array, dtype name)``: bf16 as its uint16 view (the
ranks have no ``ml_dtypes``)."""

from __future__ import annotations

import os

import numpy as np
import torch

from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed import env

from torch_dist_cases import _fleet, _np


def _tensor(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _array(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _split_layout(t, dim, hcg):
    from paddle_tpu_torch.distributed.checkpoint.metadata import (
        Layout, with_layout)
    n = hcg.get_model_parallel_world_size()
    if dim is None or n == 1:
        return t
    r = hcg.get_model_parallel_rank()
    return with_layout(t.chunk(n, dim=dim)[r].clone(),
                       Layout(split=(dim, r, n), axes=("model",)))


# ---- tensor dicts --------------------------------------------------------

def save_split(tensors, path, hybrid, values=None, async_save=False,
               **kw):
    """``tensors`` ({name: (array, dtype, split dim or None)}), each rank
    holding its part over the model group of ``hybrid``, saved with
    ``save_state_dict`` (``values`` beside them). Returns the files this
    rank wrote."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    hcg = _fleet(hybrid)
    sd = {k: _split_layout(_tensor(a, dt), dim, hcg)
          for k, (a, dt, dim) in tensors.items()}
    sd.update(values or {})
    ckpt.save_state_dict(sd, path, async_save=async_save, **kw)
    if async_save:
        ckpt.wait_async_save()
    if env.get_world_size() > 1:
        C.barrier()    # the coordinator has committed
    r = env.get_rank()
    return sorted(f for f in os.listdir(path) if f".r{r}." in f)


def load_split(shapes, path, hybrid):
    """Zero targets ({name: (shape, dtype, split dim)}) in the layout of
    ``hybrid`` loaded from ``path``: each rank's parts, the reshard
    gauges and the values."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.profiler import metrics
    hcg = _fleet(hybrid)
    reg = metrics.get_registry()
    reg.gauge("elastic/reshard_tensors").set(0)
    sd = {k: _split_layout(torch.zeros(shape, dtype=getattr(torch, dt)),
                           dim, hcg)
          for k, (shape, dt, dim) in shapes.items()}
    ckpt.load_state_dict(sd, path)
    return {"parts": {k: _array(v) for k, v in sd.items()},
            "mp_rank": hcg.get_model_parallel_rank(),
            "values": ckpt.load_values(path),
            "resharded": reg.gauge("elastic/reshard_tensors").value}


def stale_staging_save(path, value):
    """A 2-rank save of ``w`` [4, 4] split on rows, into a directory whose
    staging dir holds a crashed attempt's rank-1 files (the test made
    them): returns what this rank's save returned."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    hcg = _fleet({"mp_degree": 2})
    w = _split_layout(torch.full((4, 4), float(value)), 0, hcg)
    return ckpt.save_state_dict({"w": w, "step": value}, path,
                                barrier_timeout=60)


def ack_never_lands(path, timeout):
    """A 2-rank save whose rank 1 stages its shard but whose ack write
    keeps failing: each rank's error (both time out)."""
    from paddle_tpu_torch.distributed.checkpoint import save_load
    hcg = _fleet({"mp_degree": 2})
    if env.get_rank() == 1:
        real = save_load._atomic_write

        def failing(p, data):
            if os.path.basename(p).startswith("ack."):
                raise OSError(5, "injected: the ack never lands", p)
            return real(p, data)
        save_load._atomic_write = failing
    w = _split_layout(torch.full((4, 4), 2.0), 0, hcg)
    try:
        save_load.save_state_dict({"w": w}, path, barrier_timeout=timeout)
        return None
    except (OSError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    finally:
        if env.get_rank() == 1:
            save_load._atomic_write = real


def only_rank0_saves(path, timeout):
    """Rank 1 never calls save: rank 0's error and its wall time."""
    import time

    from paddle_tpu_torch.distributed import checkpoint as ckpt
    if env.get_rank() != 0:
        return None
    t0 = time.monotonic()
    try:
        ckpt.save_state_dict({"w": torch.ones(4)}, path,
                             barrier_timeout=timeout)
        return None, time.monotonic() - t0
    except RuntimeError as e:
        return str(e), time.monotonic() - t0


# ---- models ---------------------------------------------------------------

def _llama(fields, arrays, hcg, seed=5):
    import dataclasses

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = dataclasses.replace(LlamaConfig.tiny(), tensor_parallel=True,
                              **fields)
    model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    if arrays is not None:
        convert.from_numpy_state_dict(model, arrays, hcg=hcg)
    model.train()
    return model


def _wrap(model, opt, zero):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    if zero:
        model, opt, _ = group_sharded_parallel(model, opt, level=zero)
        return model, opt
    return fleet.distributed_model(model), fleet.distributed_optimizer(opt)


def _steps(model, opt, batches):
    from paddle_tpu_torch.io import data_replicas
    n_rep, rep = data_replicas()
    losses = []
    for ids in batches:
        rows = ids.shape[0] // n_rep
        t = torch.from_numpy(ids[rep * rows:(rep + 1) * rows])
        _, loss = model(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, rep


def llama_save(fields, arrays, batches, hybrid, path, zero=None, lr=1e-3,
               wd=0.01):
    """Tiny Llama from the JAX weights ``arrays`` under ``hybrid`` (or
    ``zero``: a ``group_sharded_parallel`` level over the sharding group)
    through AdamW steps on ``batches``, then ``hapi.Model.save_checkpoint``
    into ``path``. Returns the losses and the data replica."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _fleet(hybrid)
    model = _llama(fields, arrays, hcg)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=wd)
    model, opt = _wrap(model, opt, zero)
    losses, rep = _steps(model, opt, batches)
    m = hapi.Model(model)
    m.prepare(opt)
    m.save_checkpoint(path, epoch=0)
    return {"losses": losses, "rep": rep}


def llama_resume(fields, batches, hybrid, path, zero=None, lr=1e-3, wd=0.01):
    """Tiny Llama from another seed under ``hybrid`` (or ``zero``),
    ``hapi.Model.load_checkpoint(path)``, then AdamW steps on
    ``batches``: the losses, the data replica and the optimizer's step
    count after the load."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _fleet(hybrid)
    model = _llama(fields, None, hcg, seed=99)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=wd)
    model, opt = _wrap(model, opt, zero)
    m = hapi.Model(model)
    m.prepare(opt)
    epoch = m.load_checkpoint(path)
    step0 = opt._step_count
    losses, rep = _steps(model, opt, batches)
    return {"losses": losses, "rep": rep, "epoch": epoch, "step0": step0}


def split_model_writers(arrays, batch, path):
    """Under mp 2 (the writers that raised before multi-rank checkpoints):
    ``Model.save`` then ``Model.load`` into a model from another seed,
    ``save_state_dict``/``load_state_dict`` of ``model.state_dict()``, and
    ``fit(save_dir=)`` then ``fit(resume=True)``; a cache step still
    raises. Returns the logits before and after each load, the files
    ``save`` wrote, the resumed fit's epochs and step count, the full
    shapes ``convert`` gathers and the cache step's message."""
    import dataclasses

    from paddle_tpu_torch import convert, hapi
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _fleet({"mp_degree": env.get_world_size()})
    t = torch.from_numpy(batch)
    model = _llama({}, arrays, hcg)
    m = hapi.Model(model)
    m.prepare(AdamW(parameters=model.parameters()))
    out = {}
    with torch.no_grad():
        out["logits"] = _np(model(t))
    m.save(f"{path}/x")
    out["files"] = sorted(os.listdir(path))
    fresh = _llama({}, None, hcg, seed=77)
    m2 = hapi.Model(fresh)
    m2.prepare(AdamW(parameters=fresh.parameters()))
    m2.load(f"{path}/x")
    with torch.no_grad():
        out["after_load"] = _np(fresh(t))
    checkpoint.save_state_dict(model.state_dict(), f"{path}/c")
    C.barrier()    # the coordinator has committed
    fresh = _llama({}, None, hcg, seed=78)
    checkpoint.load_state_dict(fresh.state_dict(), f"{path}/c")
    with torch.no_grad():
        out["after_ckpt"] = _np(fresh(t))
    data = TensorDataset([t, t])
    m.prepare(AdamW(parameters=model.parameters()),
              lambda logits, y: torch.nn.functional.cross_entropy(
                  logits[:, :-1].reshape(-1, logits.shape[-1]),
                  y[:, 1:].reshape(-1)))
    m.fit(data, batch_size=2, epochs=1, verbose=0, shuffle=False,
          save_dir=f"{path}/fit", compiled=False)
    fresh = _llama({}, None, hcg, seed=79)
    m3 = hapi.Model(fresh)
    m3.prepare(AdamW(parameters=fresh.parameters()), m._loss)
    m3.fit(data, batch_size=2, epochs=2, verbose=0, shuffle=False,
           save_dir=f"{path}/fit", resume=True, compiled=False)
    out["resumed_epochs"] = [s["epoch"] for s in m3._epoch_summaries]
    out["resumed_step"] = m3._optimizer._step_count
    out["full_shapes"] = {k: v.shape for k, v in
                          convert.to_numpy_state_dict(model).items()}
    try:
        tiny = LlamaForCausalLM(dataclasses.replace(
            LlamaConfig.tiny(), tensor_parallel=True), device="cpu")
        tiny(torch.zeros(1, 2, dtype=torch.long),
             caches=tiny.init_kv_cache(1, 4), pos=0)
        out["cache_step"] = None
    except NotImplementedError as e:
        out["cache_step"] = str(e)
    return out


# ---- preemption across layouts ------------------------------------------------

def _preempt_model(hybrid, layout, w, b, opt_name, scaler):
    """``hapi.Model`` over the JAX package's Linear(8, 8) weights (``w``
    [in, out], ``b``) under ``hybrid``: a ``ColumnParallelLinear`` at mp
    above 1, the plain layer otherwise; ``layout`` "zero2" wraps the
    optimizer in ZeRO stage 2, else ``fleet.distributed_model`` /
    ``distributed_optimizer`` (DataParallel at dp above 1)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import parallel_layers as pl
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.hapi import Model
    hcg = _fleet(hybrid)
    full_w = torch.from_numpy(np.ascontiguousarray(w.T))
    full_b = torch.from_numpy(b)
    if hcg.get_model_parallel_world_size() > 1:
        net = pl.ColumnParallelLinear(8, 8, gather_output=True,
                                      device="cpu")
        with torch.no_grad():
            net.weight.copy_(pl.shard_of(net, "weight", full_w))
            net.bias.copy_(pl.shard_of(net, "bias", full_b))
    else:
        net = torch.nn.Linear(8, 8)
        with torch.no_grad():
            net.weight.copy_(full_w)
            net.bias.copy_(full_b)
    cls = topt.Adam if opt_name == "adam" else topt.Momentum
    opt = cls(0.05, parameters=net.parameters())
    if layout == "zero2":
        net, opt, _ = group_sharded_parallel(net, opt, level="os_g")
    else:
        net = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(opt)
    m = Model(net)
    m.prepare(opt, torch.nn.MSELoss(), scaler=GradScaler(
        init_loss_scaling=512.0, incr_every_n_steps=3,
        use_dynamic_loss_scaling=True) if scaler else None)
    return m


def _trip_guard(m, trip_after, grace_s=None):
    from paddle_tpu_torch.distributed.fleet.elastic import PreemptionGuard

    class TripAtStep(PreemptionGuard):
        """Reports a request once the optimizer has taken ``trip_after``
        steps: a SIGTERM landing mid-epoch on every rank at once."""

        def requested(self):
            if not super().requested() and \
                    m._optimizer._step_count >= trip_after:
                self.request()
            return super().requested()
    guard = TripAtStep()
    if grace_s is not None:
        guard.grace_s = grace_s
    return guard


def preempt_fit(hybrid, layout, w, b, x, y, opt_name, scaler, save_dir,
                trip_after, fit_kw):
    """Fit until the guard trips after ``trip_after`` steps (on every
    rank; a list gives each rank its own count), or to the end when
    ``trip_after`` is None (a resume when ``fit_kw`` has ``resume=True``).
    Returns the ``Preempted``'s epoch, step and checkpoint with the
    scaler's state and the step count at the preemption, or the final
    weights gathered, the step count and each epoch's mean loss."""
    from paddle_tpu_torch.distributed.fleet.elastic import Preempted
    from paddle_tpu_torch.distributed.sharding import full_state
    from paddle_tpu_torch.io import TensorDataset
    m = _preempt_model(hybrid, layout, w, b, opt_name, scaler)
    data = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    kw = dict(batch_size=4, epochs=3, verbose=0, shuffle=False,
              save_dir=save_dir, **fit_kw)
    if isinstance(trip_after, (list, tuple)):
        trip_after = trip_after[env.get_rank()]
    if trip_after is not None:
        try:
            m.fit(data, preemptible=_trip_guard(m, trip_after), **kw)
        except Preempted as e:
            sc = m._scaler
            return {"epoch": e.epoch, "step": e.step,
                    "checkpoint": e.checkpoint,
                    "opt_step": m._optimizer._step_count,
                    "scale": sc.get_loss_scaling() if sc else None,
                    "good": sc._good_steps if sc else None}
        return None
    m.fit(data, **kw)
    state, _ = full_state(m.network)
    return {"weight": _np(state["weight"]), "bias": _np(state["bias"]),
            "@opt_step": m._optimizer._step_count,
            "epochs": [s["epoch"] for s in m._epoch_summaries],
            "mean_losses": [s["mean_loss"] for s in m._epoch_summaries]}


def card_async_save(fields, batches, path):
    """Llama (``LlamaConfig.tiny()`` with ``fields``) at mp 2 in bf16 on
    this rank's device: AdamW steps on all but the last of ``batches``,
    an ``async_save`` of the model and optimizer
    (``hapi.Model._checkpoint_state``), then the last step while the
    writer runs. Returns the losses."""
    import dataclasses

    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    _fleet({"mp_degree": 2})
    dev = env.current_device()
    cfg = dataclasses.replace(LlamaConfig.tiny(), tensor_parallel=True,
                              **fields)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, parameters=model.parameters(),
        weight_decay=0.01))
    m = hapi.Model(model)
    m.prepare(opt)
    losses = []

    def step(ids):
        t = torch.from_numpy(ids).to(dev)
        _, loss = model(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    for ids in batches[:-1]:
        step(ids)
    ckpt.save_state_dict(m._checkpoint_state(epoch=0), path,
                         async_save=True)
    step(batches[-1])
    ckpt.wait_async_save()
    return losses
