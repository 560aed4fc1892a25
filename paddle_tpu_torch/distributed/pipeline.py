"""The FThenB and interleaved pipeline orders as tables: the port of the
schedule half of ``paddle_tpu/distributed/pipeline.py``.

The JAX package runs these orders as one ``lax.scan`` over ticks inside a
compiled program (and gets the backward from reverse-mode through it).
The port runs one process per stage rank, so the order is a table that
``fleet.meta_parallel.PipelineParallel`` walks on the host, a row a
rank, with the same encoding as ``zero_bubble.make_schedule``
(``op_table``/``mb_table`` of shape ``[S, T]``, ``NOP``/``F``/``B``):

- :func:`fthenb_forward_table`: the FThenB forward wave (fill, steady,
  drain): ``F(m, d)`` at tick ``m + d``, ``T = M + S - 1`` ticks, the
  order of ``pipeline_spmd``'s scan.
- :func:`interleaved_schedule`: the interleaved (virtual-stage) order.
  The model is cut into ``L = S * V`` chunks; chunk ``c`` lives on stage
  rank ``c % S`` as its local chunk ``c // S``. Microbatches go in groups
  of ``S``, and the forward of unit ``(m, c)`` runs at the closed-form
  tick ``t(m, c) = (m // S)·S·V + (c // S)·S + (m % S) + (c % S)``
  (``_pipeline_interleaved``). The backward mirrors it: ``B(m, c)`` runs
  at tick ``T_f + t(m, L - 1 - c)``, so every chunk's gradient arrives
  from chunk ``c + 1`` one tick before it is needed, as the reverse of
  the JAX scan runs the ring backwards.
"""

from __future__ import annotations

import numpy as np

from .zero_bubble import B, F, NOP

__all__ = ["fthenb_forward_table", "interleaved_tick",
           "interleaved_schedule"]


def fthenb_forward_table(S, M):
    """``(op_table, mb_table)`` [S, M + S - 1]: ``F(m, d)`` at tick
    ``m + d``, ``NOP`` elsewhere."""
    T = M + S - 1
    op = np.full((S, T), NOP, np.int32)
    mb = np.zeros((S, T), np.int32)
    for d in range(S):
        op[d, d:d + M] = F
        mb[d, d:d + M] = np.arange(M)
    return op, mb


def interleaved_tick(m, c, S, V):
    """The tick of the forward of microbatch ``m`` through chunk ``c``."""
    return (m // S) * S * V + (c // S) * S + (m % S) + (c % S)


def interleaved_schedule(S, M, V, backward=True):
    """``(op_table, mb_table, chunk_table)`` [S, T] of the interleaved
    order (module docstring); ``chunk_table`` holds the local chunk
    ``c // S`` of each unit. ``backward=False`` gives the forward ticks
    only (evaluation)."""
    L = S * V
    t_f = 1 + max(interleaved_tick(m, c, S, V)
                  for m in range(M) for c in range(L))
    T = 2 * t_f if backward else t_f
    op = np.full((S, T), NOP, np.int32)
    mb = np.zeros((S, T), np.int32)
    ch = np.zeros((S, T), np.int32)
    units = [(F, m, c, interleaved_tick(m, c, S, V))
             for m in range(M) for c in range(L)]
    if backward:
        units += [(B, m, c, t_f + interleaved_tick(m, L - 1 - c, S, V))
                  for m in range(M) for c in range(L)]
    for kind, m, c, t in units:
        d = c % S
        if op[d, t] != NOP:
            raise RuntimeError(f"interleaved schedule: two units on stage "
                               f"{d} at tick {t}")
        op[d, t], mb[d, t], ch[d, t] = kind, m, c // S
    return op, mb, ch
