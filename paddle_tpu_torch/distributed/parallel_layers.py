"""Tensor-parallel layers: the port of
``paddle_tpu/distributed/parallel_layers.py``.

The JAX package keeps full logical shapes and lets GSPMD insert the
collectives. The port follows Paddle's own design: each rank of the
``model`` group holds only its shard, and the collectives are explicit
``torch.autograd.Function`` pairs around the local matmuls:

- ``ColumnParallelLinear`` (weight split on its output features): the
  input through ``c_identity`` (forward identity, backward all-reduce),
  the local matmul, and with ``gather_output`` the output's last dim
  all-gathered (backward: the rank's slice);
- ``RowParallelLinear`` (weight split on its input features): the input
  split on its last dim unless ``input_is_parallel`` (backward:
  all-gather), the local matmul, then ``mp_allreduce`` (forward
  all-reduce, backward identity) and the bias, which is not split;
- ``VocabParallelEmbedding`` (rows split): ids outside the rank's rows
  are masked, the rest looked up, and the result all-reduced;
- ``ParallelCrossEntropy``: the cross entropy of vocab-split logits with
  the max, the exp-sum and the target logit all-reduced.

Every layer is a ``torch.nn.Linear``/``Embedding`` of the shard's shape
(the weight in torch's [out, in] layout), so the port's optimizers and
initialisers see an ordinary layer; ``split_dims`` names each parameter's
split dim (None: replicated), and ``full_shape``/``shard_of`` let a model
draw full weights from its seed and keep its shard (:func:`normal_`), and
``convert`` slice or gather full arrays. Each split parameter carries a
real ``is_distributed`` flag and its ``dist_layout``
(``distributed.checkpoint.metadata.Layout``: the split dim, the rank's
index, the parts), marked again after every ``_apply`` (``to_empty``
makes new parameters), and ``state_dict()``'s tensors carry the layouts,
so a checkpoint places each shard in the full tensor. Without a
``model`` group of more than one rank the layers compute as the plain
ones; the models build the plain ones then (:func:`linear`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layer import Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "split",
           "mp_info", "linear", "embedding", "normal_", "full_shape",
           "shard_of", "is_split"]


def mp_info(group=None):
    """``(group, world, rank)`` of the model-parallel group: ``group``,
    else the initialised fleet's ``model`` group; ``(None, 1, 0)`` with
    neither."""
    if group is None:
        from .fleet.base import current_hcg
        hcg = current_hcg()
        if hcg is None:
            return None, 1, 0
        group = hcg.get_model_parallel_group()
    return group, group.nranks, max(group.rank, 0)


# ---- the autograd collectives ---------------------------------------------

def _all_reduce(t, group, op="sum"):
    from .communication import all_reduce
    t = t.contiguous().clone()
    all_reduce(t, op, group)
    return t


def _all_gather(t, dim, group):
    from .communication import all_gather
    parts = all_gather([], t.contiguous(), group)
    return torch.cat(parts, dim=dim)


def _slice(t, dim, group):
    return t.chunk(group.nranks, dim=dim)[group.rank].contiguous()


def _reduce_scatter(t, dim, group):
    from .communication import reduce_scatter
    moved = t.movedim(dim, 0).contiguous()
    n = group.nranks
    if moved.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} ({moved.shape[0]}) "
                         f"is not divisible by the group's {n} ranks")
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    reduce_scatter(out, list(moved.chunk(n, dim=0)), group=group)
    return out.movedim(0, dim)


class _Identity(torch.autograd.Function):
    """``c_identity``: forward the identity, backward an all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """``mp_allreduce``: forward an all-reduce, backward the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    """Forward the rank's slice of ``dim``, backward an all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    """Forward an all-gather along ``dim``, backward the rank's slice
    (the consumer's gradient is whole on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    """Forward an all-gather along ``dim``, backward a reduce-scatter
    (the consumer is split over the group, so each rank's gradient is a
    part of the sum)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward a reduce-scatter along ``dim``, backward an all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def c_identity(x, group):
    return _Identity.apply(x, group)


def mp_allreduce(x, group):
    return _AllReduce.apply(x, group)


def split_dim(x, dim, group):
    return _Split.apply(x, dim, group)


def gather_dim(x, dim, group):
    return _Gather.apply(x, dim, group)


def all_gather_dim(x, dim, group):
    return _AllGather.apply(x, dim, group)


def reduce_scatter_dim(x, dim, group):
    return _ReduceScatter.apply(x, dim, group)


# ---- the shards ----------------------------------------------------------

def is_split(module) -> bool:
    """True for a parallel layer whose group has more than one rank."""
    return getattr(module, "split_dims", None) is not None and \
        module.mp_world > 1


def full_shape(module, name="weight"):
    """The unsplit shape of ``module``'s parameter ``name``."""
    p = getattr(module, name)
    dim = module.split_dims.get(name) if is_split(module) else None
    shape = list(p.shape)
    if dim is not None:
        shape[dim] *= module.mp_world
    return tuple(shape)


def shard_of(module, name, full):
    """The rank's part of a full-shape tensor for parameter ``name``."""
    dim = module.split_dims.get(name) if is_split(module) else None
    if dim is None:
        return full
    return full.chunk(module.mp_world, dim=dim)[module.mp_rank]


@torch.no_grad()
def normal_(module, std, generator, name="weight"):
    """``module.<name>`` from N(0, std) as the unsplit layer draws it:
    the full tensor from ``generator``, then the rank's shard (so every
    rank draws the same numbers and the shards make up the plain model's
    weight)."""
    p = getattr(module, name)
    if not is_split(module) or module.split_dims.get(name) is None:
        p.normal_(0.0, std, generator=generator)
        return
    full = p.new_empty(full_shape(module, name))
    full.normal_(0.0, std, generator=generator)
    p.copy_(shard_of(module, name, full))


def _carry_layouts(module, state, prefix, local_metadata):
    """State-dict hook: the emitted tensors keep their parameters'
    layouts (``state_dict()`` hands out detached tensors)."""
    for name, p in module._parameters.items():
        lay = getattr(p, "dist_layout", None)
        if lay is not None and prefix + name in state:
            state[prefix + name].dist_layout = lay


class _SplitLayer:
    """What the three parallel layers share: the split parameters' marks
    (module docstring)."""

    def _mark_split(self):
        from .checkpoint.metadata import Layout
        for name, dim in self.split_dims.items():
            p = self._parameters.get(name)
            if p is None:
                continue
            split = dim is not None and self.mp_world > 1
            p.is_distributed = split
            p.dist_layout = Layout(split=(dim, self.mp_rank, self.mp_world),
                                   axes=("model",)) if split else None

    def _init_split(self, group, world, rank, split_dims):
        self.group, self.mp_world, self.mp_rank = group, world, rank
        self.split_dims = split_dims
        self._mark_split()
        self._register_state_dict_hook(_carry_layouts)

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._mark_split()
        return out


def _parts(n, world, what):
    if n % world:
        raise ValueError(f"{what} ({n}) is not divisible by the "
                         f"model-parallel degree {world}")
    return n // world


def _device(device):
    from ..device import resolve_device
    return resolve_device(device)


class ColumnParallelLinear(_SplitLayer, Linear):
    """Weight [out, in] split on ``out`` over the ``model`` group; the
    output's last dim is split unless ``gather_output``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        group, world, rank = mp_info(mp_group)
        super().__init__(in_features, _parts(out_features, world,
                                             "out_features"),
                         bias=has_bias, device=_device(device), dtype=dtype)
        self._init_split(group, world, rank, {"weight": 0, "bias": 0})
        self.gather_output = gather_output

    def forward(self, x):
        if self.mp_world > 1:
            x = c_identity(x, self.group)
        out = super().forward(x)
        if self.gather_output and self.mp_world > 1:
            out = gather_dim(out, -1, self.group)
        return out


class RowParallelLinear(_SplitLayer, Linear):
    """Weight [out, in] split on ``in``; the input's last dim is split
    (``input_is_parallel``) or split here; the partial outputs are
    all-reduced, then the bias (not split) is added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        group, world, rank = mp_info(mp_group)
        super().__init__(_parts(in_features, world, "in_features"),
                         out_features, bias=has_bias,
                         device=_device(device), dtype=dtype)
        self._init_split(group, world, rank, {"weight": 1, "bias": None})
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        if self.mp_world == 1:
            return super().forward(x)
        if not self.input_is_parallel:
            x = split_dim(x, -1, self.group)
        out = mp_allreduce(_matmul(x, self.weight), self.group)
        return out if self.bias is None else out + self.bias.to(out.dtype)


def _matmul(x, weight):
    from ..amp.auto_cast import _state
    from ..nn import functional as F
    if _state.enabled:
        return F.linear(x, weight)
    return nn.functional.linear(x, weight)


class VocabParallelEmbedding(_SplitLayer, nn.Embedding):
    """The table [V, H] split on its rows over the ``model`` group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        group, world, rank = mp_info(mp_group)
        per = _parts(num_embeddings, world, "num_embeddings")
        super().__init__(per, embedding_dim, device=_device(device),
                         dtype=dtype)
        self._init_split(group, world, rank, {"weight": 0})
        self.vocab_start = rank * per

    def forward(self, ids):
        if self.mp_world == 1:
            return super().forward(ids)
        local = ids - self.vocab_start
        ok = (local >= 0) & (local < self.num_embeddings)
        out = nn.functional.embedding(torch.where(ok, local, 0),
                                      self.weight)
        out = out.masked_fill(~ok[..., None], 0.0)
        return mp_allreduce(out, self.group)


class _ParallelCE(torch.autograd.Function):
    """Per-row CE of vocab-split logits: max, exp-sum and the target
    logit (owned by one rank) all-reduced over the group."""

    @staticmethod
    def forward(ctx, logits, label, group, rank, ignore_index):
        lf = logits.float()
        v_local = lf.shape[-1]
        mx = lf.amax(-1)
        mx = _all_reduce(mx, group, "max")
        ex = torch.exp(lf - mx[..., None])
        denom = _all_reduce(ex.sum(-1), group)
        local = label.long() - rank * v_local
        ok = (local >= 0) & (local < v_local)
        safe = torch.where(ok, local, 0)
        picked = lf.gather(-1, safe[..., None])[..., 0]
        picked = _all_reduce(torch.where(ok, picked, 0.0), group)
        keep = label.long() != ignore_index
        loss = torch.where(keep, torch.log(denom) + mx - picked, 0.0)
        ctx.save_for_backward(ex, denom, safe, ok, keep)
        ctx.dtype = logits.dtype
        return loss[..., None]

    @staticmethod
    def backward(ctx, g):
        ex, denom, safe, ok, keep = ctx.saved_tensors
        grad = ex / denom[..., None]
        hit = torch.zeros_like(grad).scatter_(-1, safe[..., None],
                                              ok[..., None].float())
        scale = g[..., 0].float() * keep.float()
        return ((grad - hit) * scale[..., None]).to(ctx.dtype), None, None, \
            None, None


class ParallelCrossEntropy(nn.Module):
    """The per-token cross entropy ``[..., 1]`` of logits whose last dim
    is split over the ``model`` group (the whole vocab at one rank);
    rows labelled ``ignore_index`` give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.group, self.mp_world, self.mp_rank = mp_info(mp_group)

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label[..., 0]
        if self.mp_world == 1:
            lf = torch.log_softmax(input.float(), dim=-1)
            keep = label.long() != self.ignore_index
            safe = torch.where(keep, label.long(), 0)
            loss = -lf.gather(-1, safe[..., None])[..., 0]
            return torch.where(keep, loss, 0.0)[..., None]
        return _ParallelCE.apply(input, label, self.group, self.mp_rank,
                                 self.ignore_index)


def linear(in_f, out_f, *, column, bias=False, gather_output=False,
           input_is_parallel=True, sequence_parallel=False, device=None,
           dtype=None, enabled=True):
    """The models' projection: the plain ``Linear`` without a ``model``
    group of more than one rank (or when not ``enabled``), else the
    column or row parallel layer (their sequence-parallel forms under
    ``sequence_parallel``)."""
    if not enabled or mp_info()[1] == 1:
        return Linear(in_f, out_f, bias=bias, device=device, dtype=dtype)
    if sequence_parallel:
        from .fleet.utils.sequence_parallel_utils import (
            ColumnSequenceParallelLinear, RowSequenceParallelLinear)
        if column:
            return ColumnSequenceParallelLinear(in_f, out_f, has_bias=bias,
                                                device=device, dtype=dtype)
        return RowSequenceParallelLinear(in_f, out_f, has_bias=bias,
                                         device=device, dtype=dtype)
    if column:
        return ColumnParallelLinear(in_f, out_f, has_bias=bias,
                                    gather_output=gather_output,
                                    device=device, dtype=dtype)
    return RowParallelLinear(in_f, out_f, has_bias=bias,
                             input_is_parallel=input_is_parallel,
                             device=device, dtype=dtype)


def embedding(num, dim, *, device=None, dtype=None, enabled=True):
    """The models' token embedding: ``nn.Embedding``, or the
    vocab-parallel one under a ``model`` group of more than one rank."""
    if not enabled or mp_info()[1] == 1:
        return nn.Embedding(num, dim, device=device, dtype=dtype)
    return VocabParallelEmbedding(num, dim, device=device, dtype=dtype)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split``: a model-parallel linear (``axis`` 1:
    column, 0: row) or embedding made for this call and applied to
    ``x``. ``num_partitions`` must equal the model-parallel degree when
    there is a ``model`` group."""
    _, world, _ = mp_info()
    if world > 1 and num_partitions != world:
        raise ValueError(
            f"dist.split: num_partitions ({num_partitions}) must equal "
            f"the model-parallel world size ({world})")
    dev = x.device
    if operation == "linear":
        in_f, out_f = int(size[0]), int(size[1])
        if axis == 1:
            layer = ColumnParallelLinear(in_f, out_f,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=dev, dtype=x.dtype)
        else:
            layer = RowParallelLinear(in_f, out_f,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=not gather_out,
                                      device=dev, dtype=x.dtype)
    elif operation == "embedding":
        layer = VocabParallelEmbedding(int(size[0]), int(size[1]),
                                       device=dev)
    else:
        raise ValueError(f"dist.split: unknown operation {operation!r} "
                         "(expected 'linear' or 'embedding')")
    return layer(x)
