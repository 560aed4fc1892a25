"""Goodput ledger: the port of ``paddle_tpu/profiler/goodput.py``.

:class:`GoodputLedger` partitions one logical run's wall time, across
restart rounds, into productive time and the lost categories
(``CATEGORIES``: input wait, checkpoint save, emergency save, restart,
reshard, recompile). ``summary()`` gives the partition and
``goodput_frac = productive / wall``; with a ``path`` the ledger
persists atomically and a later round loads it, the gap between rounds
booked as ``restart``. :func:`set_current` / :func:`get_current` hold
the process's live (or most recent) ledger, which ``/statusz``'s
goodput section reads. Standard library only.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from . import metrics as _metrics
from .trace import _atomic_json_dump

__all__ = ["GoodputLedger", "CATEGORIES", "LEDGER_SCHEMA",
           "set_current", "get_current"]

# the JAX package's ledger format: a ledger either package wrote loads in
# the other
LEDGER_SCHEMA = "paddle_tpu.goodput/1"

#: the lost-time partition (see module docstring)
CATEGORIES = ("input_wait", "checkpoint_save", "emergency_save",
              "restart", "reshard", "recompile")

_metrics.declare("goodput/frac", "gauge",
                 "productive wall-time fraction across all restart "
                 "rounds (productive_s / wall_s)")
_metrics.declare("goodput/wall_s", "gauge",
                 "end-to-end wall seconds accounted by the ledger, "
                 "restart gaps included")
_metrics.declare("goodput/lost_s", "gauge",
                 "total non-productive seconds (sum of the lost "
                 "categories)")


class GoodputLedger:
    """Wall-time partition for one logical training run, spanning
    restart rounds (module docstring). ``path=None`` keeps the ledger
    in memory (no cross-round continuity); with a path, construction
    loads any previous rounds' ledger and books the gap since the last
    round was alive as ``restart`` time."""

    def __init__(self, path=None, round_=None, load=True):
        self.path = os.fspath(path) if path is not None else None
        self.round = int(os.environ.get("PADDLE_RESTART_ROUND", "0")) \
            if round_ is None else int(round_)
        self._rounds: dict[str, dict] = {}
        self._lost = {c: 0.0 for c in CATEGORIES}
        self._t_start = time.time()
        self._mono0 = time.monotonic()
        self._frozen = None     # (t_end, wall_s) pinned by close()
        # load=False: a deliberately FRESH run into a reused save_dir
        # (fit(resume=False)) must not inherit a stale ledger — the
        # days since its last round would read as restart loss
        if load and self.path is not None and os.path.exists(self.path):
            self._load_previous()

    def _load_previous(self):
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("schema") != LEDGER_SCHEMA:
                raise ValueError(f"unknown ledger schema "
                                 f"{doc.get('schema')!r}")
            self._rounds = {k: v for k, v in doc.get("rounds", {}).items()
                            if k != str(self.round)}
        except (OSError, ValueError, KeyError) as e:
            # a torn/corrupt ledger must never sink a training run —
            # start a fresh one and say so
            import warnings
            warnings.warn(f"goodput ledger at {self.path} unreadable "
                          f"({e!r}); starting fresh")
            self._rounds = {}
        # NOTE: inter-round restart gaps are NOT booked here — they are
        # derived in summary() from the persisted t_start/t_end chain,
        # so they land in wall_s AND lost_restart_s consistently and a
        # re-load can never double count them.

    # -- attribution -------------------------------------------------------

    def add(self, category, seconds):
        if category not in self._lost:
            raise ValueError(f"unknown goodput category {category!r}; "
                             f"one of {CATEGORIES}")
        if seconds > 0:
            self._lost[category] += float(seconds)

    @contextlib.contextmanager
    def measure(self, category):
        """Time a block into a lost category."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(category, time.perf_counter() - t0)

    # -- summary / persistence ---------------------------------------------

    def close(self):
        """Freeze the round's wall clock at end-of-run. ``summary()``
        and ``bench_keys()`` read the LIVE clock until then — a caller
        inspecting the ledger an hour after fit returned would
        otherwise see that idle hour booked as productive time.
        Idempotent; attribution (``add``) still lands after close."""
        if self._frozen is None:
            self._frozen = (time.time(),
                            time.monotonic() - self._mono0)

    def _this_round(self) -> dict:
        if self._frozen is not None:
            t_end, wall = self._frozen
        else:
            t_end = time.time()
            wall = time.monotonic() - self._mono0
        return {"t_start": round(self._t_start, 3),
                "t_end": round(t_end, 3),
                "wall_s": round(wall, 6),
                "lost": {c: round(v, 6)
                         for c, v in self._lost.items()}}

    def summary(self) -> dict:
        """Aggregate across every recorded round + the live one.
        Inter-round restart gaps (t_start[i+1] − t_end[i], the time no
        process was alive to measure) are derived from the persisted
        timestamps and added to BOTH wall and lost_restart, so the
        partition stays self-consistent. ``goodput_frac`` is clamped
        to [0, 1]: attribution overlap (e.g. a checkpoint save that
        also waited on input) must never report negative productive
        time."""
        rounds = dict(self._rounds)
        rounds[str(self.round)] = self._this_round()
        wall = sum(v.get("wall_s", 0.0) for v in rounds.values())
        lost = {c: 0.0 for c in CATEGORIES}
        for v in rounds.values():
            for c, s in v.get("lost", {}).items():
                if c in lost:
                    lost[c] += s
        # restart gaps between consecutive rounds, by wall-clock chain
        spans = sorted((v["t_start"], v["t_end"])
                       for v in rounds.values()
                       if isinstance(v.get("t_start"), (int, float))
                       and isinstance(v.get("t_end"), (int, float)))
        for (_, prev_end), (nxt_start, _) in zip(spans, spans[1:]):
            gap = nxt_start - prev_end
            if gap > 0:
                wall += gap
                lost["restart"] += gap
        total_lost = sum(lost.values())
        productive = max(0.0, wall - total_lost)
        frac = productive / wall if wall > 0 else 1.0
        out = {"wall_s": round(wall, 6),
               "productive_s": round(productive, 6),
               "lost_s": round(total_lost, 6),
               "goodput_frac": round(min(frac, 1.0), 6),
               "rounds": len(rounds),
               "round": self.round}
        for c in CATEGORIES:
            out[f"lost_{c}_s"] = round(lost[c], 6)
        reg = _metrics.get_registry()
        reg.gauge("goodput/frac").set(out["goodput_frac"])
        reg.gauge("goodput/wall_s").set(out["wall_s"])
        reg.gauge("goodput/lost_s").set(out["lost_s"])
        return out

    def bench_keys(self) -> dict:
        """The benchmark-record projection (the ``obs_*`` keys)."""
        s = self.summary()
        out = {"obs_goodput_frac": s["goodput_frac"],
               "obs_wall_s": round(s["wall_s"], 3)}
        for c in CATEGORIES:
            out[f"obs_lost_{c}_s"] = round(s[f"lost_{c}_s"], 3)
        return out

    def persist(self) -> str | None:
        """Atomically write the ledger (all rounds, this one current).
        Safe to call repeatedly — each epoch boundary, after an
        emergency save, and at exit all persist; the file on disk is
        always a complete document."""
        if self.path is None:
            return None
        rounds = dict(self._rounds)
        rounds[str(self.round)] = self._this_round()
        return _atomic_json_dump({"schema": LEDGER_SCHEMA,
                                  "rounds": rounds}, self.path)


# -- process-wide current ledger --------------------------------------------
# /statusz reads "the goodput summary" without a ledger handle threaded
# through the serving stack: a run registers its ledger here and leaves
# it registered afterwards (close() freezes its wall clock); None
# renders as an absent section.

_current: GoodputLedger | None = None


def set_current(ledger: GoodputLedger | None):
    """Register (or clear, with None) the process's live ledger."""
    global _current
    _current = ledger
    return ledger


def get_current() -> GoodputLedger | None:
    return _current
