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
partition's squares summed over it). Offload is not supported: it warns
and proceeds without, as the JAX package does.
"""

from __future__ import annotations

import torch
from torch import nn

from .hybrid_optimizer import base_optimizer, hybrid_clip

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


def _mp_group(hcg):
    if hcg is None:
        from .base import current_hcg
        hcg = current_hcg()
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
                    sharding_group=self.group)

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
        """This rank's partition of the optimizer state."""
        return self._inner.state_dict()

    def set_state_dict(self, state):
        self._inner.set_state_dict(state)

    def full_state_dict(self):
        """Every rank's partition merged (a collective)."""
        from ..communication import all_gather_object
        parts = []
        local = {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in self.state_dict().items()}
        all_gather_object(parts, local, self.group)
        merged = {}
        for part in parts:
            merged.update(part)
        return merged


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
    are this rank's slices; ``state_dict()`` gathers the full weights
    (every rank must call it). ``optimizer`` (built over ``layer``'s
    parameters) is moved onto the slices, its keys kept."""

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

    @torch.no_grad()
    def full_state_dict(self):
        """The layer's state dict with every parameter gathered to its
        full shape (a collective)."""
        full = {}
        for mod, name, shard in self._managed:
            shape, numel = self._meta[id(shard)]
            mod._parameters[name] = _gather_full(shard, shape, numel,
                                                 self.group)
        try:
            for k, v in self._layer.state_dict().items():
                full[k] = v.detach().clone()
        finally:
            for mod, name, _ in self._managed:
                mod._parameters[name] = None
        return full

    def state_dict(self, *args, **kwargs):
        return self.full_state_dict()

    def shards(self):
        """``[(module, name, slice)]`` of every managed parameter."""
        return list(self._managed)

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
    model = GroupShardedStage3(model, optimizer, group=group,
                               offload=offload, hcg=hcg)
    return model, optimizer, scaler
