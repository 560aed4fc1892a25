"""ZeRO sharding: the port of ``paddle_tpu/distributed/fleet/sharding.py``
(``DygraphShardingOptimizer`` for stages 1 and 2, ``GroupShardedStage3``,
``group_sharded_parallel``).

The JAX package places optimizer state (and for stage 3 the parameters)
with a ``NamedSharding`` over the ``sharding`` mesh axis and lets XLA
move the data. The port does it with its own collectives over the
sharding group, whose ranks each take their own part of the batch:

- **stage 1** (``DygraphShardingOptimizer(stage=1)``, level ``os``): the
  parameters are partitioned whole over the ranks (each to the rank that
  holds the fewest elements so far, in the optimizer's order, as Paddle
  partitions them). The gradients are averaged over the group (one
  flattened all-reduce a dtype); each rank updates only its partition,
  so only its partition has optimizer state (moments, master weights);
  then each partition is broadcast from its owner.
- **stage 2** (``stage=2``, level ``os_g``): the same, but the gradients
  are reduce-scattered: flattened in owner order, each owner's segment
  padded to the longest, one reduce-scatter (mean) hands each rank the
  gradients of its own partition, and the others are freed.
- **stage 3** (``GroupShardedStage3``, level ``p_g_os``): every parameter
  is flattened, padded to a multiple of the ranks, and each rank keeps
  its slice as the parameter the optimizer steps. The forward all-gathers
  each parameter into its module (an autograd function whose backward
  reduce-scatters the gradient's mean onto the slice); a saved-tensor
  hook keeps no gathered parameter for the backward, which gathers it
  again where autograd needs it, and the gathered copies are dropped
  after the forward.

The global-norm clip of the optimizer becomes
``hybrid_optimizer.HybridParallelClipGrad`` over the sharding group (a
partition's squares summed over it) and, under the pipeline, the
``pipe`` group. Stages 1 and 2 compose with the pipeline: a rank's
sharding group is the one at its own pipe coordinate, so it partitions
that stage's parameters only. Stage 3 under the pipeline raises. Offload is not supported: it warns
and proceeds without, as the JAX package does.

State dicts keep the unsharded model's and optimizer's keys, so a resume
at another sharding degree finds every slot under the same key. Each
rank's tensors carry their layouts (``distributed.checkpoint.metadata``):
stage 1/2 optimizer state is its owner's whole tensors (varying along
``sharding``), a stage-3 parameter or slot its flat slice. Each
``set_state_dict`` takes this rank's part of a full (or of its own)
state.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..checkpoint.metadata import Layout, layout_of, local_part, with_layout
from .hybrid_optimizer import base_optimizer, hybrid_clip, pipe_group

__all__ = ["DygraphShardingOptimizer", "group_sharded_parallel",
           "GroupShardedStage3", "partition_parameters"]


def _warn_no_offload(where: str) -> None:
    import warnings

    warnings.warn(
        f"{where}(offload=True) is not supported: parameters and "
        "optimizer state stay on the device, sharded over the group; "
        "use paddle_tpu_torch.incubate.recompute or a higher sharding "
        "degree instead. Proceeding WITHOUT offload.", UserWarning,
        stacklevel=3)


def _sharding_group(hcg, group):
    if group is not None:
        return group
    if hcg is None:
        from .base import current_hcg
        hcg = current_hcg()
    if hcg is not None:
        return hcg.get_sharding_parallel_group()
    from ..communication import get_group
    return get_group(0)


def _current_hcg():
    from .base import current_hcg
    return current_hcg()


def _mp_group(hcg):
    hcg = hcg or _current_hcg()
    return None if hcg is None else hcg.get_model_parallel_group()


def partition_parameters(params, n):
    """Each parameter's owner among ``n`` ranks: the rank holding the
    fewest elements so far, in order (ties to the lowest rank)."""
    sizes = [0] * n
    owners = []
    for p in params:
        r = min(range(n), key=lambda i: (sizes[i], i))
        owners.append(r)
        sizes[r] += p.numel()
    return owners


class DygraphShardingOptimizer:
    """ZeRO stage 1 or 2 over ``optimizer`` (module docstring)."""

    def __init__(self, optimizer, hcg=None, group=None, stage=1):
        if stage not in (1, 2):
            raise ValueError(f"DygraphShardingOptimizer: stage {stage} is "
                             "not 1 or 2 (stage 3 is GroupShardedStage3)")
        self._inner = optimizer
        self._hcg = hcg
        self.stage = stage
        self.group = _sharding_group(hcg, group)
        base = base_optimizer(optimizer)
        self._params = list(base._parameter_list)
        n = self.group.nranks
        self._owners = partition_parameters(self._params, n)
        me = max(self.group.rank, 0)
        self._owned = [p for p, o in zip(self._params, self._owners)
                       if o == me]
        hybrid_clip(optimizer, mp_group=_mp_group(hcg),
                    sharding_group=self.group,
                    pp_group=pipe_group(hcg or _current_hcg()))

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def _parameter_list(self):
        return base_optimizer(self._inner)._parameter_list

    def owned_parameters(self):
        """The parameters this rank updates (its partition)."""
        return list(self._owned)

    @torch.no_grad()
    def _sync_grads(self):
        from ..parallel import average_grads
        if self.group.nranks <= 1:
            return
        if self.stage == 1:
            average_grads(self._params, self.group)
            return
        self._reduce_scatter_grads()

    @torch.no_grad()
    def _reduce_scatter_grads(self):
        from ..communication import ReduceOp, reduce_scatter
        n, me = self.group.nranks, self.group.rank
        by_dtype = {}
        for p, o in zip(self._params, self._owners):
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append((p, o))
        for dtype, items in by_dtype.items():
            segs = [[p for p, o in items if o == r] for r in range(n)]
            lens = [sum(p.numel() for p in s) for s in segs]
            width = max(max(lens), 1)
            dev = items[0][0].grad.device
            flat = torch.zeros(n * width, dtype=dtype, device=dev)
            for r, seg in enumerate(segs):
                off = r * width
                for p in seg:
                    flat[off:off + p.numel()] = p.grad.reshape(-1)
                    off += p.numel()
            mine = torch.empty(width, dtype=dtype, device=dev)
            reduce_scatter(mine, list(flat.chunk(n)), ReduceOp.AVG,
                           self.group)
            off = 0
            for p in segs[me]:
                p.grad.copy_(mine[off:off + p.numel()].view_as(p.grad))
                off += p.numel()
            for r, seg in enumerate(segs):
                if r != me:
                    for p in seg:
                        p.grad = None

    @torch.no_grad()
    def _broadcast_params(self):
        from ..communication import broadcast
        n = self.group.nranks
        if n <= 1:
            return
        for r in range(n):
            by_dtype = {}
            for p, o in zip(self._params, self._owners):
                if o == r:
                    by_dtype.setdefault(p.dtype, []).append(p)
            for ps in by_dtype.values():
                flat = torch.cat([p.data.reshape(-1) for p in ps])
                broadcast(flat, src=self.group.ranks[r], group=self.group)
                off = 0
                for p in ps:
                    p.data.copy_(flat[off:off + p.numel()].view_as(p))
                    off += p.numel()

    @torch.no_grad()
    def step(self):
        base = base_optimizer(self._inner)
        self._sync_grads()
        pgs = [(p, p.grad) for p in self._owned
               if p.requires_grad and p.grad is not None]
        if base._grad_clip is not None:
            pgs = base._grad_clip(pgs)
        base._apply(pgs)
        self._broadcast_params()

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        """This rank's partition of the optimizer state, under the
        unsharded optimizer's keys; its tensors vary along ``sharding``."""
        state = self._inner.state_dict()
        for v in state.values():
            if isinstance(v, torch.Tensor):
                with_layout(v, (layout_of(v) or Layout()).varying(
                    "sharding"))
        return state

    def set_state_dict(self, state):
        """This rank's part of ``state`` (a full state or a partition):
        the entries of the parameters it owns, and those of none."""
        base = base_optimizer(self._inner)
        owned = {id(p) for p in self._owned}
        keep = {}
        for k, v in state.items():
            p = base._param_of(k)
            if p is None or id(p) in owned:
                keep[k] = v
        self._inner.set_state_dict(keep)


class _GatherParam(torch.autograd.Function):
    """A stage-3 slice -> the full parameter (all-gather); the backward
    reduce-scatters the gradient's mean over the group onto the slice."""

    @staticmethod
    def forward(ctx, shard, shape, numel, group):
        ctx.group, ctx.numel = group, numel
        return _gather_full(shard, shape, numel, group)

    @staticmethod
    def backward(ctx, g):
        from ..communication import ReduceOp, reduce_scatter
        n = ctx.group.nranks
        per = -(-ctx.numel // n)
        flat = g.new_zeros(per * n)
        flat[:ctx.numel] = g.reshape(-1)
        out = g.new_empty(per)
        reduce_scatter(out, list(flat.chunk(n)), ReduceOp.AVG, ctx.group)
        return out, None, None, None


def _gather_full(shard, shape, numel, group):
    from ..communication import all_gather
    parts = all_gather([], shard.detach().contiguous(), group)
    return torch.cat(parts)[:numel].view(shape)


class GroupShardedStage3(nn.Module):
    """ZeRO stage 3 over ``layer`` (module docstring). ``parameters()``
    and ``state_dict()`` are this rank's slices (under the layer's keys);
    ``optimizer`` (built over ``layer``'s parameters) is moved onto the
    slices, its keys kept."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 device=None, segment_size=2 ** 20, offload=False, hcg=None):
        super().__init__()
        if offload:
            _warn_no_offload("GroupShardedStage3")
        from ..parallel import broadcast_module
        self._layer = layer
        self.group = _sharding_group(hcg, group)
        broadcast_module(layer, self.group)
        n, me = self.group.nranks, max(self.group.rank, 0)
        self._managed = []          # (module, name, shard)
        self._meta = {}             # id(shard) -> (shape, numel)
        by_param = {}
        shards = []
        for mod in layer.modules():
            for name, p in list(mod._parameters.items()):
                if p is None:
                    continue
                shard = by_param.get(id(p))
                if shard is None:
                    numel = p.numel()
                    per = -(-numel // n)
                    flat = p.detach().new_zeros(per * n)
                    flat[:numel] = p.detach().reshape(-1)
                    shard = nn.Parameter(flat[me * per:(me + 1) * per]
                                         .clone(),
                                         requires_grad=p.requires_grad)
                    for attr, val in vars(p).items():
                        setattr(shard, attr, val)
                    shard.zero3_shape = tuple(p.shape)
                    tp = layout_of(p) or Layout()
                    shard.dist_layout = dataclasses.replace(
                        tp, flat=(me * per, (me + 1) * per,
                                  tuple(p.shape))).varying("sharding")
                    by_param[id(p)] = shard
                    self._meta[id(shard)] = (tuple(p.shape), numel)
                    shards.append((p, shard))
                mod._parameters[name] = None
                self._managed.append((mod, name, shard))
        self._shards = nn.ParameterList([s for _, s in shards])
        self._optimizer = optimizer
        if optimizer is not None:
            base = base_optimizer(optimizer)
            swap = {id(p): s for p, s in shards}
            old = base._parameter_list
            base._parameter_list = [swap.get(id(p), p) for p in old]
            # the slots keep the keys of the parameters they replace
            base._keys = {id(swap.get(id(p), p)): base._keys[id(p)]
                          for p in old}
            hybrid_clip(optimizer, mp_group=_mp_group(hcg),
                        sharding_group=self.group)
        self._live = {}

    def _pack(self, t):
        try:
            ptr = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            return t
        hit = self._live.get(ptr)
        if hit is None:
            return t
        return ("zero3", hit, tuple(t.size()), tuple(t.stride()),
                t.storage_offset())

    def _unpack(self, x):
        if not (isinstance(x, tuple) and x and x[0] == "zero3"):
            return x
        _, shard, size, stride, offset = x
        shape, numel = self._meta[id(shard)]
        with torch.no_grad():
            full = _gather_full(shard, shape, numel, self.group)
        return full.as_strided(size, stride, offset)

    def forward(self, *args, **kwargs):
        cfg = getattr(self._layer, "config", None)
        if self._layer.training and getattr(cfg, "use_recompute", False):
            # the recomputed forward runs in the backward, after the
            # gathered parameters are dropped
            raise NotImplementedError(
                "GroupShardedStage3 over a model with use_recompute=True "
                "is not ported (ROADMAP A.7); build it with "
                "use_recompute=False or use stage 1/2")
        gathered = {}
        for mod, name, shard in self._managed:
            full = gathered.get(id(shard))
            if full is None:
                shape, numel = self._meta[id(shard)]
                full = _GatherParam.apply(shard, shape, numel, self.group)
                gathered[id(shard)] = full
                self._live[full.untyped_storage().data_ptr()] = shard
            mod._parameters[name] = full
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                return self._layer(*args, **kwargs)
        finally:
            for mod, name, _ in self._managed:
                mod._parameters[name] = None
            self._live.clear()

    def state_dict(self, *args, **kwargs):
        """The layer's state dict with this rank's slice of each
        parameter (carrying its layout) under the layer's keys; buffers
        as they are. No collective: ``distributed.sharding.full_state``
        gathers."""
        for mod, name, shard in self._managed:
            mod._parameters[name] = shard
        try:
            state = self._layer.state_dict(keep_vars=True)
        finally:
            for mod, name, _ in self._managed:
                mod._parameters[name] = None
        return {k: with_layout(v.detach(), layout_of(v))
                for k, v in state.items()}

    @torch.no_grad()
    def load_state_dict(self, state_dict, strict=True, assign=False):
        """Load ``state_dict`` under the layer's keys: full tensors (each
        cut to this rank's part) or this rank's slices; ``strict``
        refuses a missing key."""
        own = self.state_dict()
        missing = sorted(set(own) - set(state_dict))
        if strict and missing:
            raise KeyError(f"GroupShardedStage3.load_state_dict: missing "
                           f"{missing}")
        for k, t in own.items():
            if k in state_dict:
                src = torch.as_tensor(state_dict[k])
                if src.numel() != t.numel():
                    src = local_part(src, layout_of(t))
                t.copy_(src.reshape(t.shape))

    set_state_dict = load_state_dict

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layer"], name)


def group_sharded_parallel(model, optimizer, level="p_g_os", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``paddle.distributed.sharding.group_sharded_parallel``. level:
    ``os`` (stage 1), ``os_g`` (stage 2) or ``p_g_os`` (stage 3). Returns
    ``(model, optimizer, scaler)``."""
    from .base import current_hcg
    hcg = current_hcg()
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"group_sharded_parallel: level {level!r} is not "
                         "'os', 'os_g' or 'p_g_os'")
    if offload and level in ("os", "os_g"):
        _warn_no_offload("group_sharded_parallel")
    if level in ("os", "os_g"):
        opt = DygraphShardingOptimizer(optimizer, hcg, group,
                                       stage=1 if level == "os" else 2)
        return model, opt, scaler
    if pipe_group(hcg) is not None:
        raise NotImplementedError(
            "ZeRO stage 3 (level 'p_g_os') under the pipeline is not "
            "ported (ROADMAP A.7): a stage rank runs its layers chunk by "
            "chunk, outside the wrapper that gathers their parameters; use "
            "level 'os' or 'os_g'")
    model = GroupShardedStage3(model, optimizer, group=group,
                               offload=offload, hcg=hcg)
    return model, optimizer, scaler
