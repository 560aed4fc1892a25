"""Activation recompute: the backward recomputes a block's activations
instead of keeping them.

Port of ``paddle_tpu/incubate/recompute.py`` (``recompute`` and the
policies ``checkpoint_with_policy`` reads from
``FLAGS_recompute_policy``). Where the JAX package wraps the block in
``jax.checkpoint``, the port runs it under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``; parameters
the block touches are found by autograd, so nothing needs to name them.

Policies:

- ``dots_saveable`` (the default): keep the outputs of the matrix
  products and recompute everything else, the port's own kernels
  included, as the JAX policy recomputes the Pallas calls. This is
  selective checkpointing: the products are the ops ``aten.mm``,
  ``aten.addmm``, ``aten.bmm`` and ``aten.baddbmm``, which is what
  ``nn.Linear`` and ``torch.matmul`` dispatch to (a 3-D ``nn.Linear``
  input is a view, ``aten.mm`` and a view back).
- ``nothing_saveable``: keep only the block's inputs.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..framework import flags

__all__ = ["recompute", "POLICIES"]

_aten = torch.ops.aten
#: the matrix products ``dots_saveable`` keeps
DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
        _aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: policy name -> the ``context_fn`` for checkpoint (None: keep nothing)
POLICIES = {
    "dots_saveable": functools.partial(create_selective_checkpoint_contexts,
                                       _dots_saveable),
    "nothing_saveable": None,
}


def recompute(function, *args, n_outputs=1, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward, under ``FLAGS_recompute_policy``. ``n_outputs`` is the
    number of tensors ``function`` returns (a tuple when more than
    one)."""
    name = flags.flag("FLAGS_recompute_policy")
    if name not in POLICIES:
        raise ValueError(f"FLAGS_recompute_policy={name!r} is not one of "
                         f"{sorted(POLICIES)}")
    context_fn = POLICIES[name]
    extra = {} if context_fn is None else {"context_fn": context_fn}
    out = checkpoint(function, *args, use_reentrant=False, **extra,
                     **kwargs)
    if n_outputs > 1 and len(out) != n_outputs:
        raise ValueError(f"recompute: {len(out)} outputs, expected "
                         f"{n_outputs}")
    return out
