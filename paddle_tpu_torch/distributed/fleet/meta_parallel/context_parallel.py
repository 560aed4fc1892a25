"""Context parallelism over the fleet's ``sep`` group: the port of
``paddle_tpu/distributed/fleet/meta_parallel/context_parallel.py``.

The JAX package has a global view: its wrappers shard a whole sequence
over the ``sep`` mesh axis inside a compiled step. Here every rank holds
its own chunk of the sequence (its loader cuts it with
:func:`split_inputs_sequence_dim`), so every wrapper is the JAX
package's "manual" path: q, k and v are this rank's [B, S_local, H, D]
chunks, and the collectives run over the hybrid group's
``get_sep_parallel_group()`` (``ops.ring_attention``). Without a fleet,
or at sep degree 1, each wrapper runs full attention on what it is
given, as the JAX ones do.

The model path (``models.llama``/``models.qwen2`` with ``sep_parallel``)
rotates q and k at their global positions (:func:`sep_positions`,
contiguous placement) and takes the loss through
:func:`sep_shifted_cross_entropy` (or the fused linear+CE): each rank's
shifted cross entropy summed over its own rows, with the first label of
the next rank's chunk for its last row, divided by the global count and
summed over the group (:func:`sep_mean`, the one rule of both). The sum's
backward is the sum of the ranks' seeds (the JAX ``psum``'s transpose),
so averaging the replicated parameters' gradients over the data x sep
ranks (``fleet.distributed_model``) gives the unpartitioned step.
"""

from __future__ import annotations

import numpy as np
import torch

from ....ops import ring_attention as ra

__all__ = ["RingFlashAttention", "ring_flash_attention", "ulysses_attention",
           "sep_attention", "sep_attention_manual", "sep_axis_is_manual",
           "split_inputs_sequence_dim", "gather_outputs_sequence_dim",
           "sep_positions", "sep_group", "sep_shifted_cross_entropy",
           "sep_sum", "sep_mean", "sep_shifted_targets", "SEP_IMPLS"]

#: the names ``sep_parallel`` and ``sep_attention(impl=)`` take
SEP_IMPLS = ("ring", "ulysses", "allgather")


def sep_group():
    """The initialised fleet's ``sep`` group when it has more than one
    rank, else None."""
    from ..base import current_hcg
    hcg = current_hcg()
    if hcg is None or hcg.get_sep_parallel_world_size() <= 1:
        return None
    return hcg.get_sep_parallel_group()


def _degree(group):
    return group.nranks if group is not None else 1


def _full(q, k, v, causal, scale):
    """Full attention, exact in f32 (the JAX fallback's
    ``sdpa_reference``), with ``scale``."""
    return ra.chunked_attention(q, k, v, causal=causal, scale=scale,
                                chunk=max(k.shape[1], 1))


def _core(impl, q, k, v, group, causal, scale, placement="contiguous"):
    if impl not in SEP_IMPLS:
        raise ValueError(f"unknown sep impl {impl!r}")
    if impl != "ring" and placement != "contiguous":
        # zigzag is the ring's causal load-balancing layout; the other
        # impls assume contiguous global positions
        raise ValueError(
            f"placement={placement!r} is only supported with "
            f"impl='ring' (got impl={impl!r})")
    if group is None:
        return _full(q, k, v, causal, scale)
    if impl == "ring":
        return ra.ring_attention(q, k, v, group, causal=causal, scale=scale,
                                 placement=placement)
    if impl == "ulysses":
        return ra.ulysses_attention(q, k, v, group, causal=causal,
                                    scale=scale)
    return ra.allgather_attention(q, k, v, group, causal=causal, scale=scale)


def ring_flash_attention(q, k, v, causal=True, scale=None,
                         placement="contiguous"):
    """Exact attention over the ``sep``-split sequence by the K/V ring;
    q/k/v this rank's chunks [B, S_local, H, D]. Full attention at sep
    degree 1."""
    return _core("ring", q, k, v, sep_group(), causal, scale, placement)


# PaddleNLP class-style alias
RingFlashAttention = ring_flash_attention


def ulysses_attention(q, k, v, causal=True, scale=None):
    """Ulysses attention (all-to-all head <-> sequence) over the ``sep``
    group; full attention at sep degree 1."""
    return _core("ulysses", q, k, v, sep_group(), causal, scale)


def sep_attention(q, k, v, causal=True, scale=None, impl="ring",
                  placement="contiguous"):
    """Context-parallel attention of this rank's chunks by ``impl``
    (``ring``, ``ulysses`` or ``allgather``); a placement other than
    ``contiguous`` is refused off the ring. Full attention at sep degree
    1."""
    return _core(impl, q, k, v, sep_group(), causal, scale, placement)


def sep_axis_is_manual() -> bool:
    """True when the ``sep`` group has more than one rank: every rank
    holds its own chunk, so the sep axis is always manual here."""
    return sep_group() is not None


def sep_rope(sin_tab, cos_tab, seq_local, group, build=None):
    """(sin, cos) [1, S_local, D/2] at this rank's global positions
    ``sep_rank * S_local + [0..S_local)`` (contiguous placement), from
    tables that cover the global length (``build(length)`` makes longer
    ones when the given tables are too short; positions are never
    clamped)."""
    n, r = _degree(group), max(group.rank, 0) if group is not None else 0
    if n * seq_local > sin_tab.shape[0]:
        sin_tab, cos_tab = build(n * seq_local)
    lo = r * seq_local
    return (sin_tab[None, lo:lo + seq_local],
            cos_tab[None, lo:lo + seq_local])


def sep_attention_manual(q, k, v, rope_theta, causal=True, scale=None,
                         impl="ring"):
    """The JAX manual path: pre-RoPE local chunks [B, S_local, H, D],
    rotated at their global positions from a table of the global length,
    then ``impl`` over the ``sep`` group."""
    from ....ops.rope import build_sin_cos, rotate
    group = sep_group()
    sl, d = q.shape[1], q.shape[-1]
    n = _degree(group)
    sin, cos = sep_rope(*build_sin_cos(n * sl, d, rope_theta,
                                       device=q.device), sl, group)
    return _core(impl, rotate(q, sin, cos), rotate(k, sin, cos), v, group,
                 causal, scale)


def _default_rank(degree, rank):
    if rank is not None:
        return rank
    from ..base import current_hcg
    hcg = current_hcg()
    if hcg is not None and hcg.get_sep_parallel_world_size() == degree:
        return hcg.get_sep_parallel_rank()
    return None


def split_inputs_sequence_dim(inputs, rank=None, degree=None, axis=1,
                              zigzag=False):
    """This rank's slice of host batches on the sequence dim (tensors,
    arrays, or lists, tuples and dicts of them): the (optionally zigzag-
    reordered) sequence cut into ``degree`` equal parts, part ``rank``.
    ``degree`` and ``rank`` default to the fleet's sep degree and rank;
    without a rank the whole (reordered) sequence is returned. A degree
    of 1 returns the inputs as they are."""
    if degree is None:
        degree = _degree(sep_group())
    if degree <= 1:
        return inputs
    rank = _default_rank(degree, rank)

    def one(t):
        if t.shape[axis] % degree:
            raise ValueError(
                f"sequence length {t.shape[axis]} not divisible by sep "
                f"degree {degree}")
        if zigzag:
            t = ra.zigzag_reorder(t, degree, axis=axis)
        if rank is None:
            return t
        per = t.shape[axis] // degree
        sl = [slice(None)] * t.ndim
        sl[axis] = slice(rank * per, (rank + 1) * per)
        return t[tuple(sl)]

    if isinstance(inputs, (list, tuple)):
        return type(inputs)(one(t) for t in inputs)
    if isinstance(inputs, dict):
        return {k: one(v) for k, v in inputs.items()}
    return one(inputs)


def gather_outputs_sequence_dim(outputs, degree=None, axis=1, zigzag=False):
    """The whole sequence from this rank's chunk of a tensor: its
    ``sep`` group's chunks all-gathered on ``axis`` in rank order
    (backward: the rank's slice), then the zigzag order undone. An array,
    or a tensor without a sep group of ``degree`` ranks, is taken as the
    whole sequence already: only the zigzag order is undone."""
    group = sep_group()
    if degree is None:
        degree = _degree(group)
    if degree <= 1:
        return outputs
    if isinstance(outputs, torch.Tensor) and _degree(group) == degree:
        from ...parallel_layers import gather_dim
        outputs = gather_dim(outputs, axis, group)
    if zigzag:
        outputs = ra.zigzag_restore(outputs, degree, axis=axis)
    return outputs


def sep_positions(seq_len, degree=None, zigzag=False):
    """Global RoPE positions of a sequence of ``seq_len`` tokens split
    over the sep ranks (optionally zigzag), int32 numpy [seq_len]; a
    rank's part is its slice (:func:`split_inputs_sequence_dim`)."""
    if degree is None:
        degree = _degree(sep_group())
    if zigzag and degree > 1:
        return ra.zigzag_positions(seq_len, degree)
    return np.arange(seq_len, dtype=np.int32)


# ---- the loss over the split sequence ----------------------------------------

def sep_sum(x, group):
    """``x`` summed over ``group``; the backward sums the ranks' seeds
    (every rank seeds the same loss, so each local part's gradient is n
    times its seed, the JAX ``psum``'s transpose)."""
    from ...parallel_layers import psum
    return psum(x, group)


def _next_first_labels(labels, group):
    """The first label column of the next rank's chunk ([B, 1]); None on
    the group's last rank."""
    from ...parallel_layers import _all_gather
    firsts = _all_gather(labels[:, :1].contiguous(), 0, group)
    n, r = group.nranks, group.rank
    if r == n - 1:
        return None
    b = labels.shape[0]
    return firsts[(r + 1) * b:(r + 2) * b]


def sep_shifted_targets(labels, group):
    """``(targets, keep_last)``: this rank's shifted targets (its labels
    from position 1 on, then the next rank's first label; the last rank
    has no label for its last row, ``keep_last`` False)."""
    nxt = _next_first_labels(labels, group)
    targets = labels[:, 1:] if nxt is None else \
        torch.cat([labels[:, 1:], nxt.to(labels.dtype)], dim=1)
    return targets, nxt is not None


def sep_mean(rank_sum, targets, group, ignore_index=-100, extra=None):
    """The group's loss from this rank's: ``rank_sum`` (its rows' summed
    loss against ``targets``) over the count of labelled rows of the
    whole group, plus ``extra / n`` (a per-rank term averaged over the
    group, such as a router aux loss), summed over ``group``
    (:func:`sep_sum`). The one weighting rule of every sep loss."""
    from ...parallel_layers import _all_reduce
    local = (targets != ignore_index).sum().float()
    count = _all_reduce(local.reshape(1), group)[0]
    part = rank_sum / count.clamp(min=1)
    if extra is not None:
        part = part + extra / group.nranks
    return sep_sum(part, group)


def sep_shifted_cross_entropy(logits, labels, group, ignore_index=-100,
                              extra=None):
    """The unpartitioned model's shifted next-token cross entropy (the
    mean over the labelled rows of the whole sequence) from this rank's
    chunk: logits [B, S_local, V], labels [B, S_local]. Each rank sums
    its rows' cross entropy (log-softmax in f32) and :func:`sep_mean`
    makes the group's loss of the sums."""
    targets, keep_last = sep_shifted_targets(labels, group)
    rows = logits if keep_last else logits[:, :-1]
    lf = torch.log_softmax(rows.reshape(-1, rows.shape[-1]).float(), dim=-1)
    idx = targets.reshape(-1).long()
    mask = idx != ignore_index
    nll = -lf.gather(-1, torch.where(mask, idx, 0)[:, None])[:, 0]
    return sep_mean(torch.where(mask, nll, 0.0).sum(), targets, group,
                    ignore_index, extra)
