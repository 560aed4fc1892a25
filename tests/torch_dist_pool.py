"""A pool of CPU ranks for the multi-rank tests of the port.

``RankPool(n)`` starts ``n`` fresh processes (``spawn``), each of which
joins one gloo process group through ``paddle_tpu_torch.distributed.
init_parallel_env(device="cpu")`` at a free local port with one torch
thread (``device="cuda"``: the ranks share the card, so the backend rule
takes gloo through host buffers), then runs tasks: ``pool.run("module:function", *args)`` calls the
function on every rank and returns the ranks' results in rank order. A
rank's exception fails the call with its traceback; a call (or the
start) that takes longer than its limit kills the pool and fails, so a
hang ends the test instead of the suite's clock. The ranks import only
torch and ``paddle_tpu_torch`` (and the task's module); the JAX oracle
runs in the test process.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import queue
import socket
import time
import traceback

#: seconds a start or a task may take before the pool is killed
LIMIT_S = 120.0


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, device, inbox, outbox):
    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(n),
                       "PADDLE_LOCAL_RANK": str(rank),
                       "PADDLE_LOCAL_SIZE": str(n),
                       "PADDLE_MASTER": f"127.0.0.1:{port}",
                       "OMP_NUM_THREADS": "1"})
    try:
        import torch
        torch.set_num_threads(1)
        from paddle_tpu_torch.distributed import env
        env.init_parallel_env(device=None if device == "cuda" else device,
                              timeout=LIMIT_S)
        outbox.put((rank, "ready", None))
    except BaseException:
        outbox.put((rank, "error", traceback.format_exc()))
        return
    while True:
        task = inbox.get()
        if task is None:
            break
        path, args = task
        try:
            mod, fn = path.split(":")
            out = getattr(importlib.import_module(mod), fn)(*args)
            outbox.put((rank, "ok", out))
        except BaseException:
            outbox.put((rank, "error", traceback.format_exc()))


class RankPool:
    def __init__(self, n, limit=LIMIT_S, device="cpu"):
        ctx = multiprocessing.get_context("spawn")
        self.n, self.limit = n, limit
        self._out = ctx.Queue()
        self._in = [ctx.Queue() for _ in range(n)]
        port = _free_port()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n, port, device, self._in[r],
                                         self._out),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        self._collect("start", limit)

    def _collect(self, what, limit):
        end = time.monotonic() + limit
        got = {}
        while len(got) < self.n:
            left = end - time.monotonic()
            try:
                rank, status, value = self._out.get(timeout=max(left, 0.01))
            except queue.Empty:
                self.close(kill=True)
                raise AssertionError(
                    f"{what}: ranks {sorted(set(range(self.n)) - set(got))} "
                    f"gave no answer in {limit} s") from None
            if status == "error":
                self.close(kill=True)
                raise AssertionError(f"{what}: rank {rank} failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.n)]

    def alive(self):
        return all(p.is_alive() for p in self._procs)

    def run(self, path, *args, limit=None):
        """``path`` ("module:function") on every rank; the results in
        rank order."""
        for q in self._in:
            q.put((path, args))
        return self._collect(path, limit or self.limit)

    def close(self, kill=False):
        if not kill:
            for q, p in zip(self._in, self._procs):
                if p.is_alive():
                    q.put(None)
            for p in self._procs:
                p.join(10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
