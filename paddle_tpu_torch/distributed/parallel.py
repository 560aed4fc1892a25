"""``DataParallel``: the port of ``paddle_tpu/distributed/parallel.py``.

The JAX package shards the batch over the ``data`` mesh axis and lets
GSPMD average the gradients inside the compiled step. The port holds a
whole replica on each rank of the ``data`` group and averages the
gradients itself, with its own collectives (never torch's
``DistributedDataParallel``):

- at construction the parameters and buffers are broadcast from the
  group's first rank, so every replica starts from its weights;
- the first gradient a backward accumulates queues a callback at the end
  of that backward (``queue_callback``), which flattens every gradient
  into one buffer per dtype, all-reduces it as a mean over the group
  (the strategy's ``"avg"``) and writes the means back: one collective a
  dtype a step, the reference's reducer with a single bucket;
- inside ``no_sync()`` nothing is reduced, so gradients accumulate
  locally; the next synced backward averages the accumulated sums;
- ``apply_collective_grads()`` averages the current gradients at once
  (for a loop that steps without a synced backward); ``scale_loss``
  returns the loss as it is, as the JAX package's does (the mean is in
  the reduction).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

__all__ = ["DataParallel"]


def _data_group(group):
    if group is not None:
        return group
    from .fleet.base import current_hcg
    hcg = current_hcg()
    if hcg is not None:
        return hcg.get_data_parallel_group()
    from .communication import get_group
    return get_group(0)


@torch.no_grad()
def average_grads(params, group):
    """Every ``p.grad`` of ``params`` averaged over ``group``, one
    flattened all-reduce a dtype."""
    from .communication import ReduceOp, all_reduce
    if group.nranks <= 1:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        all_reduce(flat, ReduceOp.AVG, group)
        offset = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


@torch.no_grad()
def broadcast_module(module, group):
    """Parameters and buffers from the group's first rank."""
    from .communication import broadcast
    if group.nranks <= 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        broadcast(t.data, src=group.ranks[0], group=group)


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.group = _data_group(group)
        self._sync = True
        self._queued = False
        broadcast_module(layers, self.group)
        if self.group.nranks > 1:
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._grad_ready)

    def _grad_ready(self, _param):
        if not self._sync or self._queued:
            return
        self._queued = True
        torch.autograd.Variable._execution_engine.queue_callback(
            self._reduce)

    def _reduce(self):
        self._queued = False
        self.apply_collective_grads()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backward passes inside accumulate their gradients locally."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        average_grads(self._layers.parameters(), self.group)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)
