"""Transfers between pipeline stage ranks: Paddle's
``fleet/meta_parallel/pp_utils/p2p_communication.py``, over the port's
``distributed.communication`` p2p on the fleet's ``pipe`` group.

A stage's message is a tuple of tensors (one activation, or the
``(hidden, residual)`` pair of a fused residual carry). Sends are
``isend``: a send never waits for its receiver, so a stage rank can walk
its row of the schedule table without ever blocking on a peer that is
itself sending; receives block. Each directed pair of ranks carries its
messages in the order both ends walk their rows (the tables make every
consumer's order its producer's), which is what matches them, under
gloo as under NCCL.

Every step, the first activation sent on a pair is preceded by its
meta (count, dtypes and shapes, one int64 tensor), so the receiver
allocates its buffers from it; a stage is shape-preserving, so one meta
serves the step. Gradients need none: a stage receives the gradients of
what it sent, in the same shapes. Under interleaving the same functions
carry the wrap from the last stage to the first.
"""

from __future__ import annotations

import torch

from ....communication import isend, recv

__all__ = ["SendRecv"]

#: the dtypes a message may hold (their index is the meta's code)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8, torch.int8)
_META_LEN = 64
_MAX_DIMS = 8


def _encode(tensors, device):
    meta = [len(tensors)]
    for t in tensors:
        if t.dim() > _MAX_DIMS:
            raise ValueError(f"pipeline p2p: a {t.dim()}-d message "
                             f"(at most {_MAX_DIMS} dims)")
        meta += [_DTYPES.index(t.dtype), t.dim()] + list(t.shape) + \
            [0] * (_MAX_DIMS - t.dim())
    if len(meta) > _META_LEN:
        raise ValueError(f"pipeline p2p: {len(tensors)} tensors in one "
                         "message is too many")
    return torch.tensor(meta + [0] * (_META_LEN - len(meta)),
                        dtype=torch.int64, device=device)


def _decode(meta):
    vals = meta.tolist()
    out, i = [], 1
    for _ in range(vals[0]):
        dtype, ndim = _DTYPES[vals[i]], vals[i + 1]
        out.append((tuple(vals[i + 2:i + 2 + ndim]), dtype))
        i += 2 + _MAX_DIMS
    return out


class SendRecv:
    """One step's transfers of this stage rank over ``group`` (the fleet's
    ``pipe`` group); peers are global ranks. :meth:`wait` ends the step:
    it waits for every send (each peer has received by then)."""

    def __init__(self, group, device):
        self.group, self.device = group, device
        self._sent_meta = set()
        self._metas = {}
        self._works = []

    def _send(self, tensors, dst):
        for t in tensors:
            self._works.append(isend(t.detach().contiguous(), dst,
                                     self.group))

    def send_forward(self, tensors, dst):
        """Activations to the stage rank ``dst`` (the next chunk's)."""
        if dst not in self._sent_meta:
            self._sent_meta.add(dst)
            self._send([_encode(tensors, self.device)], dst)
        self._send(tensors, dst)

    def recv_forward(self, src, requires_grad):
        """The next activations from ``src``: new tensors, floating ones
        leaves that require grad when ``requires_grad``."""
        spec = self._metas.get(src)
        if spec is None:
            meta = torch.empty(_META_LEN, dtype=torch.int64,
                               device=self.device)
            recv(meta, src, self.group)
            spec = self._metas[src] = _decode(meta)
        out = []
        for shape, dtype in spec:
            t = torch.empty(shape, dtype=dtype, device=self.device)
            recv(t, src, self.group)
            out.append(t.requires_grad_(requires_grad
                                        and t.is_floating_point()))
        return out

    def send_backward(self, grads, dst):
        """Input gradients to the stage rank ``dst`` (the previous
        chunk's), one per floating activation it sent."""
        self._send(grads, dst)

    def recv_backward(self, src, like):
        """The gradients of the floating tensors of ``like`` (what this
        rank sent to ``src``)."""
        out = []
        for t in like:
            if t.is_floating_point():
                g = torch.empty_like(t, memory_format=torch.contiguous_format)
                recv(g, src, self.group)
                out.append(g)
        return out

    def wait(self):
        works, self._works = self._works, []
        for w in works:
            w.wait()
        self._sent_meta.clear()
        self._metas.clear()
