"""``paddle.distributed.spawn``: the port of
``paddle_tpu/distributed/spawn_api.py``.

Starts ``nprocs`` fresh processes (``multiprocessing``'s ``spawn``
context: no CUDA context is inherited) that run ``func(*args)`` with the
launcher's rank environment (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``)
and a rendezvous address on ``127.0.0.1`` at a free port
(``PADDLE_MASTER``, unless the caller's environment sets one).
``options["env"]`` adds variables to every rank's environment. With
``join`` it waits for every rank, at most ``timeout`` seconds when given;
a rank that fails, or the timeout, terminates the others and raises.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import time

__all__ = ["spawn", "free_port"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(func, rank, nprocs, args, env):
    os.environ.update(env)
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_RANK": str(rank),
        "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_WORLD_SIZE": str(nprocs),
        "PADDLE_LOCAL_SIZE": str(nprocs),
    })
    func(*args)


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(func, args=(), nprocs=1, join=True, daemon=False, timeout=None,
          **options):
    """Run ``func(*args)`` in ``nprocs`` fresh processes; returns the
    processes (module docstring)."""
    ctx = multiprocessing.get_context("spawn")
    env = dict(options.get("env") or {})
    if not os.environ.get("PADDLE_MASTER") and "PADDLE_MASTER" not in env:
        env["PADDLE_MASTER"] = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(int(nprocs)):
        p = ctx.Process(target=_entry, args=(func, rank, nprocs, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    end = None if timeout is None else time.monotonic() + float(timeout)
    try:
        while any(p.is_alive() for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"paddle.distributed.spawn: ranks {bad} exited nonzero "
                    f"({[procs[i].exitcode for i in bad]})")
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"paddle.distributed.spawn: ranks did "
                                   f"not finish in {timeout} s")
            time.sleep(0.05)
        bad = [i for i, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(
                f"paddle.distributed.spawn: ranks {bad} exited nonzero "
                f"({[procs[i].exitcode for i in bad]})")
    finally:
        _stop(procs)
    return procs
