"""``PipelineLayer``: the port of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py`` (fleet's
``parallel_layers/pp_layers.py``).

A model is an ordered list of layer descriptions (``LayerDesc``: a class
and its arguments), cut into segments by ``_partition`` (``uniform``, or
``layer:<Class>`` to cut at the layers of one class), one segment a
pipeline stage, or under ``num_virtual_pipeline_stages = V`` one a chunk
of ``S * V`` chunks, chunk ``c`` on stage rank ``c % S``. The segments
are the JAX package's for every count of layers and stages.

The JAX package builds every layer in one program and lets the compiled
pipeline place each stage's weights on its devices. The port runs one
process per rank, as Paddle does: **a rank builds and holds only the
layers of its own chunks**, on its device. The layers keep the JAX keys
(``run_function.<global index>.…``) whichever stage holds them, so a
state dict names a layer the same way at every pp degree; each held
parameter also takes ``param_<global position>`` as its name, so an
optimizer's state keys are the unpartitioned model's too. At
``pp_degree == 1`` (or without a fleet) the rank holds every layer and
``forward`` runs them in order, tuples flowing between layers as they
come.

A layer the rank does not hold is built, when something asks for it, on
the meta device (its shapes, no memory): ``parameters_by_stage`` counts
every stage's parameters that way, and :meth:`PipelineLayer.reset_parameters`
walks every layer in order with one generator, drawing a missing
layer's tensors into scratch buffers reused by shape, so a stage's
weights are the ones the unpartitioned model of the same seed draws.

``SharedLayerDesc`` ties a weight between two places (a tied embedding
and head): both owning ranks hold the layer, under the key of its first
place, from the same draw (and broadcast from the first owner), and
``allreduce_shared_weight_gradients`` sums its gradient between them
before the update; the later owner's copy is marked ``pipe_duplicate``
so the global-norm clip counts it once. ``recompute_interval`` wraps
every run of that many layers of a chunk in ``incubate.recompute`` when
training, except layers that recompute inside themselves
(``handles_recompute``).
"""

from __future__ import annotations

import inspect

import torch
from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "LocalSharedLayerDesc",
           "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self, **extra) -> nn.Module:
        return self.layer_cls(*self.inputs, **self.kwargs, **extra)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class LocalSharedLayerDesc(SharedLayerDesc):
    """The JAX package's (and Paddle's) ``LocalSharedLayerDesc``: kept as
    a type of its own for parity; the port shares it as
    ``SharedLayerDesc``."""


class _FnLayer(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _SharedLayerRef(nn.Module):
    """A later place of a ``SharedLayerDesc``: the first place's layer,
    not registered again (through ``forward_func`` when given)."""

    def __init__(self, target, forward_func=None):
        super().__init__()
        self._target = [target]
        self._forward_func = forward_func

    def forward(self, x):
        target = self._target[0]
        if self._forward_func is not None:
            return self._forward_func(target, x)
        return target(x)


def _kind(desc):
    """The class names a ``layer:<Class>`` segmentation matches a layer
    by: its class and the classes it derives from."""
    cls = desc.layer_cls if isinstance(desc, LayerDesc) else \
        type(desc) if isinstance(desc, nn.Module) else _FnLayer
    return tuple(k.__name__ for k in cls.__mro__)


def _partition(kinds, n, stages, seg_method="uniform"):
    """The JAX package's ``PipelineLayer._partition``: ``stages``
    segments ``(start, end)`` of ``n`` layers, ``kinds[i]`` naming layer
    ``i``'s classes."""
    if seg_method.startswith("layer:"):
        cls_name = seg_method.split(":", 1)[1]
        marks = [i for i, k in enumerate(kinds) if cls_name in k]
        if len(marks) >= stages:
            per = len(marks) // stages
            bounds = [0] + [marks[s * per] for s in range(1, stages)] + [n]
            return [(bounds[i], bounds[i + 1]) for i in range(stages)]
    base, rem = divmod(n, stages)
    segs, start = [], 0
    for s in range(stages):
        size = base + (1 if s < rem else 0)
        segs.append((start, start + size))
        start += size
    return segs


def _build(desc, device, dtype):
    """Layer ``desc`` on ``device`` (``device``/``dtype`` passed where
    its class takes them, and the default device for the rest)."""
    if not isinstance(desc, LayerDesc):
        return desc if isinstance(desc, nn.Module) else _FnLayer(desc)
    try:
        takes = inspect.signature(desc.layer_cls).parameters
    except (TypeError, ValueError):
        takes = {}
    extra = {}
    if "device" in takes and "device" not in desc.kwargs:
        extra["device"] = device
    if dtype is not None and "dtype" in takes and "dtype" not in desc.kwargs:
        extra["dtype"] = dtype
    with torch.device(device):
        return desc.build_layer(**extra)


def _pipe_info(num_stages):
    """``(hcg, stages, stage)``: the fleet's pipe degree and this rank's
    stage when the fleet splits the pipe axis into ``num_stages``."""
    from ..base import current_hcg
    hcg = current_hcg()
    pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
    if num_stages is None:
        num_stages = pp
    num_stages = max(int(num_stages), 1)
    if pp > 1 and num_stages != pp:
        raise ValueError(f"PipelineLayer: num_stages={num_stages} differs "
                         f"from the fleet's pp_degree {pp}")
    return hcg, num_stages, hcg.get_stage_id() if pp > 1 else None


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None,
                 device=None, dtype=None):
        super().__init__()
        from ....device import resolve_device
        self._descs = list(layers)
        self._loss_fn = loss_fn
        self._topo = topology
        self._seg_method = seg_method
        self._recompute_interval = int(recompute_interval or 0)
        self._hcg, self._num_stages, stage = _pipe_info(num_stages)
        if num_virtual_pipeline_stages is None:
            from ..base import fleet
            cfg = fleet.strategy.pipeline_configs if fleet.strategy else {}
            num_virtual_pipeline_stages = cfg.get(
                "num_virtual_pipeline_stages")
        self._num_virtual = max(int(num_virtual_pipeline_stages or 1), 1)
        self._device = resolve_device(device)
        self._dtype = dtype
        n, S = len(self._descs), self._num_stages
        self._segments = _partition([_kind(d) for d in self._descs], n,
                                    S * self._num_virtual, seg_method)
        # this rank's chunks: all of them without a split pipe axis
        self._stage = stage
        self._chunks = list(range(len(self._segments))) if stage is None \
            else list(range(stage, len(self._segments), S))
        held = [i for c in self._chunks for i in range(*self._segments[c])]
        self._first_of = {}         # shared key -> index of its first place
        for i, d in enumerate(self._descs):
            if isinstance(d, SharedLayerDesc):
                self._first_of.setdefault(d.layer_name, i)
        self.run_function = nn.ModuleDict()
        self._refs = {}             # later places of shared layers
        for i in held:
            d = self._descs[i]
            first = self._first_of.get(getattr(d, "layer_name", None), i)
            if first != i:
                if str(first) not in self.run_function:
                    self.run_function[str(first)] = _build(
                        self._descs[first], self._device, dtype)
                self._refs[i] = _SharedLayerRef(
                    self.run_function[str(first)], d.forward_func)
            else:
                self.run_function[str(i)] = _build(d, self._device, dtype)
        # keep run_function in global order (a shared layer may have been
        # placed early)
        order = sorted(self.run_function.keys(), key=int)
        self.run_function = nn.ModuleDict(
            {k: self.run_function[k] for k in order})
        self._meta = {}
        if stage is not None:
            self._name_parameters()
            self._shared_groups = self._make_shared_groups()
            self._sync_shared()

    # ---- what the rank holds -------------------------------------------

    def _layer(self, i):
        """Layer ``i`` as this rank runs it (held layers only)."""
        if i in self._refs:
            return self._refs[i]
        return self.run_function[str(i)]

    def chunk_layers(self, v):
        """The layers of this rank's local chunk ``v``, in order."""
        return [self._layer(i) for i in range(*self._segments[
            self._chunks[v]])]

    def chunk_parameters(self, v):
        """The parameters of local chunk ``v`` (a shared layer's with the
        chunk that holds any place of it)."""
        seen, out = set(), []
        for layer in self.chunk_layers(v):
            target = layer._target[0] if isinstance(layer, _SharedLayerRef) \
                else layer
            for p in target.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    out.append(p)
        return out

    @property
    def num_chunks(self):
        return len(self._chunks)

    def meta_layer(self, i):
        """Layer ``i`` built on the meta device (cached)."""
        from ....models.llama import _NoMetaInit
        if i not in self._meta:
            with _NoMetaInit():
                self._meta[i] = _build(self._descs[i], "meta", self._dtype)
        return self._meta[i]

    def _owns_params(self, i):
        """True where layer ``i`` holds parameters of its own (not the
        later place of a shared layer)."""
        d = self._descs[i]
        return self._first_of.get(getattr(d, "layer_name", None), i) == i

    def get_stage_layers(self, stage_id):
        """The layers of stage ``stage_id``'s chunks: the held ones, and
        meta copies of the others."""
        out = []
        for c in range(stage_id, len(self._segments), self._num_stages):
            for i in range(*self._segments[c]):
                held = str(i) in self.run_function or i in self._refs
                out.append(self._layer(i) if held else self.meta_layer(i))
        return out

    @property
    def parameters_by_stage(self):
        """Each stage's parameters: this rank's own, meta tensors of the
        same shapes for the others (a shared weight counts on every stage
        that holds it)."""
        out = []
        for s in range(self._num_stages):
            seen, ps = set(), []
            for layer in self.get_stage_layers(s):
                if isinstance(layer, _SharedLayerRef):
                    layer = layer._target[0]
                for p in layer.parameters():
                    if id(p) not in seen:
                        seen.add(id(p))
                        ps.append(p)
            out.append(ps)
        return out

    def _global_params(self):
        """``[(index, layer)]`` of every layer that owns parameters, held
        ones real and the others meta, in global order."""
        out = []
        for i in range(len(self._descs)):
            if not self._owns_params(i):
                continue
            held = str(i) in self.run_function
            out.append((i, self.run_function[str(i)] if held
                        else self.meta_layer(i)))
        return out

    def _name_parameters(self):
        """``param_<global position>`` on each held parameter: the key
        the unpartitioned model's optimizer gives it."""
        pos = 0
        for i, layer in self._global_params():
            for p in layer.parameters():
                if str(i) in self.run_function:
                    p.param_name = f"param_{pos}"
                pos += 1

    def global_state_keys(self):
        """Every key of the unpartitioned ``PipelineLayer``'s state dict."""
        keys = []
        for i, layer in self._global_params():
            keys += [f"run_function.{i}.{k}" for k in layer.state_dict()]
        return keys

    # ---- shared weights ----------------------------------------------------

    def _shared_stages(self):
        """``{key: sorted stages holding a place of it}``."""
        S = self._num_stages
        out = {}
        for i, d in enumerate(self._descs):
            if isinstance(d, SharedLayerDesc):
                c = next(c for c, (a, b) in enumerate(self._segments)
                         if a <= i < b)
                out.setdefault(d.layer_name, set()).add(c % S)
        return {k: sorted(v) for k, v in sorted(out.items()) if len(v) > 1}

    def _make_shared_groups(self):
        """``{key: group}`` of the ranks that hold a shared layer and
        share this rank's other coordinates (every rank makes every group,
        in one order)."""
        from ...communication import new_group
        topo = self._hcg.topology()
        groups = {}
        for key, stages in self._shared_stages().items():
            for ranks in topo.get_comm_list("pipe"):
                g = new_group([ranks[s] for s in stages],
                              axis_name="pipe_shared")
                if self._stage in stages and self._hcg.global_rank in \
                        g.ranks:
                    groups[key] = g
            if key in groups and self._stage != stages[0]:
                first = self.run_function[str(self._first_of[key])]
                for p in first.parameters():
                    p.pipe_duplicate = True
        return groups

    @torch.no_grad()
    def _sync_shared(self):
        from ...communication import broadcast
        for key, g in self._shared_groups.items():
            layer = self.run_function[str(self._first_of[key])]
            for p in layer.parameters():
                broadcast(p.data, src=g.ranks[0], group=g)

    @torch.no_grad()
    def allreduce_shared_weight_gradients(self):
        """Sum each shared weight's gradient over the ranks holding it."""
        from ...communication import all_reduce
        for key, g in getattr(self, "_shared_groups", {}).items():
            layer = self.run_function[str(self._first_of[key])]
            for p in layer.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                all_reduce(p.grad, group=g)

    # ---- weights from a seed ---------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, seed, init_layer):
        """``init_layer(layer, generator)`` on every layer in global order
        with one generator seeded by ``seed``: a held layer's tensors
        take their draws, a missing layer's go into scratch buffers
        (reused by shape and dtype), so the generator advances as the
        unpartitioned model's walk advances it."""
        gen = torch.Generator(device=self._device).manual_seed(int(seed))
        scratch = {}
        for i in range(len(self._descs)):
            if not self._owns_params(i):
                continue
            if str(i) in self.run_function:
                init_layer(self.run_function[str(i)], gen)
                continue
            layer = self.meta_layer(i)
            swapped = []
            for mod in layer.modules():
                for name, p in mod._parameters.items():
                    if p is None:
                        continue
                    key = (tuple(p.shape), p.dtype)
                    if key not in scratch:
                        scratch[key] = torch.empty(
                            key[0], dtype=p.dtype, device=self._device)
                    swapped.append((mod, name, p))
                    mod._parameters[name] = nn.Parameter(
                        scratch[key], requires_grad=False)
            try:
                init_layer(layer, gen)
            finally:
                for mod, name, p in swapped:
                    mod._parameters[name] = p

    # ---- forward ----------------------------------------------------------

    def _run(self, layers, x):
        interval = self._recompute_interval
        if not (interval and self.training and torch.is_grad_enabled()):
            for layer in layers:
                x = layer(x)
            return x
        from ....incubate.recompute import recompute
        run = []

        def flush(x):
            if not run:
                return x
            group = list(run)
            run.clear()

            def block(*args):
                h = args if len(args) > 1 else args[0]
                for layer in group:
                    h = layer(h)
                return h
            args = x if isinstance(x, tuple) else (x,)
            return recompute(block, *args)

        for layer in layers:
            if getattr(layer, "handles_recompute", False):
                x = flush(x)
                x = layer(x)
                continue
            run.append(layer)
            if len(run) == interval:
                x = flush(x)
        return flush(x)

    def forward_chunk(self, v, x):
        """This rank's local chunk ``v`` over ``x``."""
        return self._run(self.chunk_layers(v), x)

    def forward(self, x):
        """Every held layer in order: the whole model where the rank
        holds every layer (``pp_degree == 1``)."""
        if self._stage is not None:
            raise RuntimeError(
                "PipelineLayer.forward at pp_degree > 1: a stage rank holds "
                "only its chunks; run it through PipelineParallel "
                "(fleet.distributed_model)")
        held = sorted(set(int(k) for k in self.run_function)
                      | set(self._refs))
        return self._run([self._layer(i) for i in held], x)
