"""The pipeline schedules as tables: the port of the schedule half of
``paddle_tpu/distributed/zero_bubble.py`` (host-side Python and numpy,
copied so that the port imports nothing of the JAX package).

``make_schedule(S, M, kind)`` is the JAX package's greedy lock-step list
scheduler: for every tick ``t`` and stage ``d`` it records the work unit
(``NOP``/``F``/``B``/``W``) and its microbatch. ``kind`` is ``fthenb``
(every forward first, GPipe), ``1f1b`` (backward first, at most
``S - d`` microbatches in flight on stage ``d``) or ``zb_h1`` (1F1B with
the backward split into ``B``, the input gradient, and ``W``, the weight
gradient, which fills ticks 1F1B would leave idle). ``_buffer_slots``
is the peak number of stage inputs (and received gradients) a stage
keeps alive under a table: the memory bound the 1F1B and ZB-H1 tables
exist to give. The JAX package runs a table inside one compiled
program; the port's ``fleet.meta_parallel.PipelineParallel`` walks each
stage rank's row of it on the host, with p2p between the stage ranks.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_schedule", "NOP", "F", "B", "W"]

NOP, F, B, W = 0, 1, 2, 3


# --------------------------------------------------------------------------
# Schedule construction (static, host-side)
# --------------------------------------------------------------------------

def make_schedule(S, M, kind="1f1b"):
    """Greedy lock-step list scheduler.

    Model: at each tick every stage executes one work unit; a message
    sent at tick t (F's activation to stage d+1, B's gradient to stage
    d-1) is available to its consumer from tick t+1.

    Readiness rules:
      F(m, 0)   : always.
      F(m, d)   : F(m, d-1) finished at some tick <= t-1.
      B(m, S-1) : F(m, S-1) finished at <= t-1 (input x[m] saved; loss
                  vjp recomputes the forward).
      B(m, d)   : B(m, d+1) finished at <= t-1 (gradient arrived).
      W(m, d)   : B(m, d) finished (same stage, earlier tick).

    Policies:
      fthenb: priority F > B, no in-flight cap (GPipe shape).
      1f1b  : priority B > F; in-flight cap (F issued - B done) <= S-d.
      zb_h1 : priority B > F > W; same cap; W fills idle ticks.

    Returns (op_table, mb_table): np.int32 arrays of shape [S, T].
    """
    if kind not in ("fthenb", "1f1b", "zb_h1"):
        raise ValueError(f"unknown pipeline schedule '{kind}'")
    split_w = kind == "zb_h1"
    f_done = [[-1] * M for _ in range(S)]   # tick F(m,d) completed
    b_done = [[-1] * M for _ in range(S)]
    w_done = [[-1] * M for _ in range(S)]
    f_next = [0] * S                        # microbatches issued in order
    b_next = [0] * S
    w_next = [0] * S                        # W issued FIFO too
    ops, mbs = [], []
    t = 0
    total = S * M * (3 if split_w else 2)
    done = 0
    while done < total:
        row_op = [NOP] * S
        row_mb = [0] * S
        for d in range(S):
            cap = S - d
            f_ready = (f_next[d] < M and
                       (d == 0 or f_done[d - 1][f_next[d]] >= 0) and
                       (kind == "fthenb" or
                        f_next[d] - b_next[d] < cap))
            m = b_next[d]
            if d == S - 1:
                b_ready = m < M and f_done[d][m] >= 0
            else:
                b_ready = m < M and b_done[d + 1][m] >= 0
            w_ready = (split_w and w_next[d] < M
                       and b_done[d][w_next[d]] >= 0)
            if kind == "fthenb":
                order = ("F", "B")
            else:
                order = ("B", "F", "W") if split_w else ("B", "F")
            for o in order:
                if o == "F" and f_ready:
                    row_op[d], row_mb[d] = F, f_next[d]
                    break
                if o == "B" and b_ready:
                    row_op[d], row_mb[d] = B, m
                    break
                if o == "W" and w_ready:
                    row_op[d], row_mb[d] = W, w_next[d]
                    break
        # commit the tick (completion recorded after selection so a
        # message sent this tick is consumable only from t+1)
        for d in range(S):
            o, m = row_op[d], row_mb[d]
            if o == F:
                f_done[d][m] = t
                f_next[d] += 1
                done += 1
            elif o == B:
                b_done[d][m] = t
                b_next[d] += 1
                done += 1
            elif o == W:
                w_done[d][m] = t
                w_next[d] += 1
                done += 1
        ops.append(row_op)
        mbs.append(row_mb)
        t += 1
        if t > 8 * (M + S) * (3 if split_w else 2) + 64:
            raise RuntimeError("schedule construction did not converge")
    op_table = np.array(ops, dtype=np.int32).T  # [S, T]
    mb_table = np.array(mbs, dtype=np.int32).T
    return op_table, mb_table


def _buffer_slots(op_table, mb_table, S, M, split_w):
    """Static buffer sizing: the peak number of simultaneously-live
    stage inputs (x) and banked gradients (g) across stages.

    x[m] on stage d is live from its banking tick (activation arrival =
    F(m,d-1)+1; F tick itself on stage 0) until its last use (W(m,d)
    when split, else B(m,d)). g[m] is live from B(m,d+1)+1 until W(m,d)
    / B(m,d). Both are issued and released in microbatch order (FIFO),
    so the live set is a contiguous window and ``slot = m % K`` with K =
    peak window size is collision-free. This is what makes 1F1B/ZB-H1's
    in-flight cap an actual memory bound — K is S-ish, not M.
    """
    f_at = {}
    b_at = {}
    w_at = {}
    T = op_table.shape[1]
    for t in range(T):
        for d in range(S):
            o, m = int(op_table[d, t]), int(mb_table[d, t])
            if o == F:
                f_at[(d, m)] = t
            elif o == B:
                b_at[(d, m)] = t
            elif o == W:
                w_at[(d, m)] = t

    def peak(intervals):
        events = []
        for s, e in intervals:
            events.append((s, 1))
            events.append((e + 1, -1))
        events.sort()
        cur = best = 0
        for _, delta in events:
            cur += delta
            best = max(best, cur)
        return best

    kx = kg = 1
    for d in range(S):
        x_iv = []
        g_iv = []
        for m in range(M):
            start = f_at[(d, m)] if d == 0 else f_at[(d - 1, m)] + 1
            end = w_at[(d, m)] if split_w else b_at[(d, m)]
            x_iv.append((start, end))
            if d < S - 1:
                g_start = b_at[(d + 1, m)] + 1
                g_end = w_at[(d, m)] if split_w else b_at[(d, m)]
                g_iv.append((g_start, g_end))
        kx = max(kx, peak(x_iv))
        if g_iv:
            kg = max(kg, peak(g_iv))
    return kx, kg
