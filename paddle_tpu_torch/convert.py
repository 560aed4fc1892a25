"""The weight bridge to and from the JAX package's state dict.

``from_numpy_state_dict(model, arrays)`` loads a ``paddle_tpu`` model's
``state_dict()``, given as numpy arrays under the same keys, into the
port's model. Paddle's Linear holds its weight as [in, out] and
``torch.nn.Linear`` as [out, in], so every Linear weight (``lm_head``
included) is transposed; embeddings ([V, H]) and norm weights are taken
as they are. A missing or unexpected key raises. The keys of every
family are the JAX package's: GPT-2's head is tied to ``gpt2.wte`` and
adds no key; ERNIE's ``mlm_bias`` (a bias, not a Linear) and the MoE
expert stacks (``mlp.moe.w_gate`` [E, d, h], ...: Qwen2-MoE's and
DeepSeek-V2's) are taken untransposed; ``ErnieForMaskedLM`` holds its
encoder once, under ``_pre.ernie``.

``to_numpy_state_dict(model)`` and ``grads_to_numpy(model)`` go the other
way: the port's weights, or their gradients, as f32 numpy arrays in the
JAX package's layout (Linear weights transposed back).

Tensor parallelism: a parallel layer's parameter (``distributed.
parallel_layers``) holds this rank's shard, placed by its layout
(``distributed.checkpoint.metadata``), so ``from_numpy_state_dict``
slices each full array to it (after the transpose), and
``to_numpy_state_dict``/``grads_to_numpy`` all-gather the shards of every
rank back to full shapes (collectives over the fleet's groups: every
rank calls them, in the same order). A ZeRO stage-3 model
(``GroupShardedStage3``) is gathered the same way by
``to_numpy_state_dict``; load its weights before wrapping it.

``from_numpy_optimizer_state(model, state)`` turns a JAX optimizer's
``state_dict()`` (numpy arrays) into the port's, and
``to_numpy_optimizer_state`` goes back, so both packages can continue
one run from the same state. Both key a parameter's slots by its
position (``param_<i>_<slot>``, ``param_<i>_master``), and both models
list their parameters in the same order (the state-dict order), so a
key names the same parameter on both sides. A Linear weight's moments,
master copy and other slots of its shape are transposed as the weight
is; beta powers (0-d) are not. ``@step``, ``LR_Scheduler`` and keys of
named parameters keep their names and values.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = ["from_numpy_state_dict", "to_numpy_state_dict", "grads_to_numpy",
           "from_numpy_optimizer_state", "to_numpy_optimizer_state"]


def _linear_keys(model: nn.Module) -> set[str]:
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def _unwrap(model):
    """The layer inside ``DataParallel``/fleet's AMP wrapper."""
    from .distributed.fleet.base import AmpModelWrapper
    from .distributed.parallel import DataParallel
    while isinstance(model, (DataParallel, AmpModelWrapper)):
        model = model._layers if isinstance(model, DataParallel) \
            else model.model
    return model


@torch.no_grad()
def from_numpy_state_dict(model: nn.Module, arrays: dict[str, np.ndarray],
                          hcg=None) -> nn.Module:
    """Load full-shape JAX arrays into ``model``; a tensor-parallel
    layer's parameters take this rank's slice (``hcg``, when given, must
    be the fleet topology the model was built under)."""
    from .distributed.checkpoint.metadata import layout_of, local_part
    from .distributed.fleet.sharding import GroupShardedStage3
    if isinstance(model, GroupShardedStage3):
        raise TypeError("from_numpy_state_dict: load the weights into the "
                        "layer before wrapping it in GroupShardedStage3")
    model = _unwrap(model)
    target = model.state_dict()
    if hcg is not None:
        world = hcg.get_model_parallel_world_size()
        for dst in target.values():
            lay = layout_of(dst)
            if lay is not None and lay.split and lay.split[2] != world:
                raise ValueError(f"the model is split over {lay.split[2]} "
                                 f"ranks, the topology's model group has "
                                 f"{world}")
    missing = sorted(set(target) - set(arrays))
    unexpected = sorted(set(arrays) - set(target))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    linear = _linear_keys(model)
    for key, dst in target.items():
        src = np.asarray(arrays[key])
        if src.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy
            src = src.astype(np.float32)
        if key in linear:
            src = src.T
        # this rank's part of a split parameter (its layout)
        src = local_part(torch.from_numpy(np.ascontiguousarray(src)),
                         layout_of(dst)).numpy()
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} does not "
                             f"fit {tuple(dst.shape)}")
        dst.copy_(torch.tensor(src))
    return model


def _to_numpy(tensors: dict[str, torch.Tensor],
              linear: set[str]) -> dict[str, np.ndarray]:
    out = {}
    for key, t in tensors.items():
        a = t.detach().float().cpu().numpy()
        out[key] = np.ascontiguousarray(a.T) if key in linear else a
    return out


def to_numpy_state_dict(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's state dict as f32 numpy arrays in the JAX package's
    layout, tensor-parallel and ZeRO stage-3 parameters gathered to full
    shapes (``distributed.sharding.full_state``): the inverse of
    :func:`from_numpy_state_dict`."""
    from .distributed.fleet.sharding import GroupShardedStage3
    from .distributed.sharding import full_state
    if isinstance(model, GroupShardedStage3):
        layer = _unwrap(model._layer)
    else:
        model = layer = _unwrap(model)
    return _to_numpy(full_state(model)[0], _linear_keys(layer))


def grads_to_numpy(model: nn.Module) -> dict[str, np.ndarray]:
    """Each parameter's gradient (parameters without one are left out),
    as f32 numpy arrays under the state-dict keys, in the JAX package's
    layout, tensor-parallel ones gathered to full shapes."""
    from .distributed.checkpoint.metadata import layout_of
    from .distributed.fleet.base import current_hcg
    from .distributed.sharding import gather_full
    model = _unwrap(model)
    hcg = current_hcg()
    mp = hcg.get_model_parallel_group() if hcg is not None else None
    grads = {name: gather_full(p.grad, layout_of(p), mp, None)
             for name, p in model.named_parameters() if p.grad is not None}
    return _to_numpy(grads, _linear_keys(model))


_SLOT = re.compile(r"param_(\d+)_(.+)")


def _convert_slots(model, state, convert):
    """``convert(value, transpose)`` each ``param_<i>_<slot>`` value, the
    transpose decided by the model's i-th parameter; keys stay as they
    are and other keys pass through."""
    names = [n for n, _ in model.named_parameters()]
    linear = _linear_keys(model)
    out = {}
    for key, v in state.items():
        m = _SLOT.fullmatch(key)
        out[key] = v if m is None else convert(
            v, names[int(m.group(1))] in linear)
    return out


def from_numpy_optimizer_state(model: nn.Module, state: dict) -> dict:
    """A JAX optimizer's ``state_dict()`` (values as numpy arrays) as the
    port's optimizer over ``model.parameters()`` takes it (module
    docstring); slots become f32 CPU tensors."""
    def convert(v, transpose):
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy
            a = a.astype(np.float32)
        if transpose and a.ndim == 2:
            a = a.T
        return torch.tensor(a)
    return _convert_slots(model, state, convert)


def to_numpy_optimizer_state(model: nn.Module, state: dict) -> dict:
    """The port's optimizer ``state_dict()`` as f32 numpy arrays in the
    JAX package's layout: the inverse of
    :func:`from_numpy_optimizer_state`."""
    def convert(v, transpose):
        a = v.detach().float().cpu().numpy()
        return np.ascontiguousarray(a.T) if transpose and a.ndim == 2 else a
    return _convert_slots(model, state, convert)
