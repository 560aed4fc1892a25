"""Activation recompute: the backward recomputes a block's activations
instead of keeping them.

Port of ``paddle_tpu/incubate/recompute.py`` (``recompute`` and the
policies ``checkpoint_with_policy`` reads from
``FLAGS_recompute_policy``). Where the JAX package wraps the block in
``jax.checkpoint``, the port runs it under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``; parameters
the block touches are found by autograd, so nothing needs to name them.

The policies are selective checkpointing over the aten ops the block
dispatches (what ``jax.checkpoint_policies`` decides over ``dot_general``
and named values):

- ``dots_saveable`` (the default): keep the outputs of the matrix
  products and recompute everything else, the port's own kernels
  included, as the JAX policy recomputes the Pallas calls. The products
  are ``aten.mm``, ``aten.addmm``, ``aten.bmm`` and ``aten.baddbmm``,
  which is what ``nn.Linear`` and ``torch.matmul`` dispatch to (a 3-D
  ``nn.Linear`` input is a view, ``aten.mm`` and a view back).
- ``dots_with_no_batch_dims_saveable``: only the products without a
  batch dimension, ``aten.mm`` and ``aten.addmm`` (the Linear
  projections), as the JAX policy keeps ``dot_general`` with no batch
  dimension; the batched ``bmm``/``baddbmm`` are recomputed.
- ``dots_and_flash_saveable``: ``dots_saveable`` plus the flash
  attention forward's outputs (the operator ``paddle_tpu_torch::
  flash_fwd``, K7), so the backward never launches K7 again: the JAX
  policy's ``flash_out`` name.
- ``everything_saveable``: keep every output; nothing is recomputed.
- ``nothing_saveable``: keep only the block's inputs.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..framework import flags
from ..ops.kernels import flash_attention  # noqa: F401 (registers FLASH)

__all__ = ["recompute", "POLICIES"]

_aten = torch.ops.aten
#: the products without a batch dimension
DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)
#: the matrix products ``dots_saveable`` keeps
DOTS = DOTS_NO_BATCH + (_aten.bmm.default, _aten.baddbmm.default)
#: the flash forward, named as the JAX policy names ``flash_out``
FLASH = (torch.ops.paddle_tpu_torch.flash_fwd.default,)


def _keep(ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _everything(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE


#: policy name -> the ``context_fn`` for checkpoint (None: keep nothing)
POLICIES = {
    "dots_saveable": _keep(DOTS),
    "nothing_saveable": None,
    "dots_with_no_batch_dims_saveable": _keep(DOTS_NO_BATCH),
    "everything_saveable": functools.partial(
        create_selective_checkpoint_contexts, _everything),
    "dots_and_flash_saveable": _keep(DOTS + FLASH),
}
# the JAX package's order, for its error message
_POLICY_NAMES = ("dots_saveable", "nothing_saveable",
                 "dots_with_no_batch_dims_saveable", "everything_saveable",
                 "dots_and_flash_saveable")


def recompute(function, *args, n_outputs=1, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward, under ``FLAGS_recompute_policy``. ``n_outputs`` is the
    number of tensors ``function`` returns (a tuple when more than
    one). An unknown policy name raises the JAX package's message."""
    name = flags.flag("FLAGS_recompute_policy")
    if name not in POLICIES:
        raise ValueError(
            f"FLAGS_recompute_policy={name!r} is not a known policy; "
            f"choose one of {_POLICY_NAMES}")
    context_fn = POLICIES[name]
    extra = {} if context_fn is None else {"context_fn": context_fn}
    out = checkpoint(function, *args, use_reentrant=False, **extra,
                     **kwargs)
    if n_outputs > 1 and len(out) != n_outputs:
        raise ValueError(f"recompute: {len(out)} outputs, expected "
                         f"{n_outputs}")
    return out
