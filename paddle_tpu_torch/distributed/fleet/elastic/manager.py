"""The elastic manager: the heartbeat registry, the fault watch and the
checkpoint-restart helpers, ported from
``paddle_tpu/distributed/fleet/elastic/manager.py``.

Two registry backends behind one API:

- **store**: a key-value store with ``set``/``get``/``delete_key`` (a
  ``torch.distributed.TCPStore`` works; where the store has ``check``,
  a missing key is read as missing instead of waited for). Each worker
  ``set``\\ s its heartbeat key; the watcher flags ranks whose
  timestamp went stale. The multi-host path.
- **dir**: a shared directory; each worker rewrites ``heartbeat.{rank}``
  and the watcher checks mtimes. The single-host path, and the one the
  launcher's watchdog uses.

Standard library only.
"""

from __future__ import annotations

import enum
import os
import threading
import time

__all__ = ["ElasticManager", "ElasticStatus", "start_heartbeat",
           "stop_heartbeat", "latest_checkpoint", "checkpoint_step",
           "latest_valid_checkpoint"]


class ElasticStatus(enum.Enum):
    HEALTHY = 0
    STALE = 1       # some rank missed its heartbeat window
    INCOMPLETE = 2  # not all ranks have registered yet


# ---- worker side: the heartbeat thread ------------------------------------

_worker = {"thread": None, "stop": None}


def _beat_once(rank, directory=None, store=None):
    now = str(time.time())
    if directory is not None:
        with open(os.path.join(directory, f"heartbeat.{rank}"), "w") as f:
            f.write(now)
    if store is not None:
        store.set(f"elastic/beat/{rank}", now.encode())


def start_heartbeat(rank=None, directory=None, store=None, interval=1.0):
    """Start this process's daemon heartbeat thread (one per process: a
    second call replaces the first). ``rank`` and ``directory`` default
    from the launcher's ``PADDLE_ELASTIC_HEARTBEAT_RANK`` (else
    ``PADDLE_LOCAL_RANK``) and ``PADDLE_ELASTIC_HEARTBEAT_DIR``, so a
    script can call it with no arguments. False when there is no
    registry to beat into."""
    if rank is None:
        rank = int(os.environ.get("PADDLE_ELASTIC_HEARTBEAT_RANK",
                                  os.environ.get("PADDLE_LOCAL_RANK",
                                                 "0")))
    if directory is None:
        directory = os.environ.get("PADDLE_ELASTIC_HEARTBEAT_DIR")
    if directory is None and store is None:
        return False
    stop_heartbeat()
    if directory is not None:
        os.makedirs(directory, exist_ok=True)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                _beat_once(rank, directory, store)
            except Exception:  # noqa: BLE001 — never kill the trainer
                pass
            stop.wait(interval)

    _beat_once(rank, directory, store)
    t = threading.Thread(target=loop, name="elastic-heartbeat",
                         daemon=True)
    t.start()
    _worker["thread"], _worker["stop"] = t, stop
    return True


def stop_heartbeat():
    if _worker["stop"] is not None:
        _worker["stop"].set()
        _worker["thread"].join(timeout=2.0)
        _worker["thread"] = _worker["stop"] = None


# ---- watcher side ---------------------------------------------------------

class ElasticManager:
    """Fault watcher over the heartbeat registry: :meth:`watch` returns
    an :class:`ElasticStatus` and the caller (the launcher) decides what
    to do: kill the local workers and relaunch from the newest
    checkpoint."""

    def __init__(self, world_size, directory=None, store=None,
                 timeout=10.0):
        if directory is None and store is None:
            raise ValueError("ElasticManager needs a directory or store")
        self.world_size = int(world_size)
        self.directory = directory
        self.store = store
        self.timeout = float(timeout)

    def _store_get(self, key):
        check = getattr(self.store, "check", None)
        if check is not None and not check([key]):
            return None
        return self.store.get(key)

    def _beats(self):
        beats = {}
        if self.directory is not None:
            for r in range(self.world_size):
                try:
                    beats[r] = os.path.getmtime(
                        os.path.join(self.directory, f"heartbeat.{r}"))
                except OSError:
                    pass
        if self.store is not None:
            for r in range(self.world_size):
                v = self._store_get(f"elastic/beat/{r}")
                if v:
                    beats[r] = max(beats.get(r, 0.0), float(v))
        return beats

    def watch(self, ignore=()):
        """One poll: ``(status, ranks)``. ``ignore`` names ranks exempt
        from staleness (workers that already exited cleanly)."""
        beats = self._beats()
        watched = [r for r in range(self.world_size) if r not in ignore]
        missing = [r for r in watched if r not in beats]
        if missing:
            return ElasticStatus.INCOMPLETE, missing
        now = time.time()
        stale = [r for r in watched if now - beats[r] > self.timeout]
        if stale:
            # the no-progress signal: a flight-recorder bundle from the
            # watcher before the launcher tears the round down
            from ....profiler import flight_recorder as _frec
            _frec.record_event("heartbeat_stale", ranks=list(stale),
                               gap_s=round(now - min(
                                   beats[r] for r in stale), 3))
            rec = _frec.get_recorder()
            if rec is not None:
                try:
                    rec.dump(f"elastic heartbeat gap: ranks {stale} "
                             f"stale past {self.timeout}s")
                except OSError:
                    pass    # the launcher must still see STALE
            return ElasticStatus.STALE, stale
        return ElasticStatus.HEALTHY, []

    def wait_all_registered(self, timeout=60.0, poll=0.2):
        end = time.time() + timeout
        while time.time() < end:
            if self.watch()[0] is not ElasticStatus.INCOMPLETE:
                return True
            time.sleep(poll)
        return False

    def reset(self):
        """Clear the registered beats (before a relaunch round)."""
        for r in range(self.world_size):
            if self.directory is not None:
                try:
                    os.remove(os.path.join(self.directory,
                                           f"heartbeat.{r}"))
                except OSError:
                    pass
            if self.store is not None:
                try:
                    self.store.delete_key(f"elastic/beat/{r}")
                except Exception:  # noqa: BLE001 — best effort
                    pass


# ---- checkpoint-restart helpers -------------------------------------------

def checkpoint_step(path):
    """The step of a ``step_N`` checkpoint directory's name, else -1."""
    base = os.path.basename(os.path.normpath(path))
    if base.startswith("step_"):
        try:
            return int(base[len("step_"):])
        except ValueError:
            pass
    return -1


def latest_checkpoint(root):
    """The newest ``step_N`` directory under ``root`` by name alone, or
    None; staging directories (``.tmp`` in the name) are ignored. It
    does not check that the checkpoint loads: restarts take
    :func:`latest_valid_checkpoint`."""
    if not os.path.isdir(root):
        return None
    best, best_step = None, -1
    for name in os.listdir(root):
        full = os.path.join(root, name)
        if not os.path.isdir(full) or ".tmp" in name:
            continue
        s = checkpoint_step(full)
        if s > best_step:
            best, best_step = full, s
    return best


def latest_valid_checkpoint(root, deep=False):
    """The newest *committed* ``step_N`` checkpoint under ``root``
    (sentinel and metadata checksums validated; torn, staging and
    corrupt saves skipped), through ``distributed.checkpoint.validation``,
    which imports no torch."""
    from ...checkpoint.validation import \
        latest_valid_checkpoint as _latest_valid
    return _latest_valid(root, deep=deep)
