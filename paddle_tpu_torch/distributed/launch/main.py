"""The launcher: the port of ``paddle_tpu/distributed/launch/main.py``,
with its flags and its behaviour.

Elastic fault tolerance, the launcher half (the workers hold the other
half: ``fleet.elastic.PreemptionGuard`` and ``fit(preemptible=)``):

- **three worker fates.** A *clean preemption* (exit
  ``PREEMPTED_EXIT_CODE`` = 75, after a committed emergency checkpoint)
  relaunches on its own budget, ``--max_preempt_restarts``; a *crash*
  (any other nonzero exit) and a *stale heartbeat* (a hung worker) burn
  ``--max_restarts``;
- **relaunch.** With ``--min_nproc_per_node`` a crashed rank's slot is
  taken as lost and the next round runs with the surviving world. Each
  round exports ``PADDLE_RESTART_ROUND`` and, with ``--checkpoint_dir``,
  the newest *committed* checkpoint as ``PADDLE_RESUME_CHECKPOINT`` /
  ``PADDLE_RESUME_STEP``;
- restarts back off exponentially (``--elastic_timeout`` base,
  ``--max_backoff`` cap) within hard budgets, so a broken job fails
  loudly;
- a SIGTERM to the launcher itself is forwarded to every worker, which
  gets ``--grace`` seconds to checkpoint; the launcher then exits 75
  without a relaunch;
- a failed worker's log tail goes to the launcher's stderr.

``--devices`` sets ``CUDA_VISIBLE_DEVICES`` for the workers. Standard
library only: nothing here imports torch.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch_main"]

#: fleet.elastic.PREEMPTED_EXIT_CODE, written out so that the launcher's
#: imports stay minimal
PREEMPTED_EXIT_CODE = 75


def _parse():
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch")
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="coordinator ip:port")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")))
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_RANK", "0")))
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes per node")
    p.add_argument("--min_nproc_per_node", type=int, default=0,
                   help="if > 0, a crashed rank's slot is treated as "
                        "lost and the next round respawns with the "
                        "surviving world size, never below this floor "
                        "(0 = always respawn at full size). Single-"
                        "node only: with --nnodes > 1 it is ignored "
                        "with a warning")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--devices", default=None,
                   help="CUDA_VISIBLE_DEVICES for the workers")
    p.add_argument("--max_restarts", type=int,
                   default=int(os.environ.get("PADDLE_MAX_RESTARTS", "0")))
    p.add_argument("--max_preempt_restarts", type=int,
                   default=int(os.environ.get(
                       "PADDLE_MAX_PREEMPT_RESTARTS", "16")),
                   help="separate budget for clean preemptions (exit "
                        "code 75)")
    p.add_argument("--elastic_timeout", type=int, default=30,
                   help="base restart delay; doubles every consecutive "
                        "restart up to --max_backoff")
    p.add_argument("--max_backoff", type=float, default=300.0)
    p.add_argument("--grace", type=float,
                   default=float(os.environ.get("PADDLE_PREEMPT_GRACE_S",
                                                "30")),
                   help="seconds workers get between the launcher's "
                        "SIGTERM forward and SIGKILL")
    p.add_argument("--heartbeat_timeout", type=float, default=0.0,
                   help="if > 0, watch worker heartbeats (workers call "
                        "fleet.elastic.start_heartbeat) and treat a "
                        "stale rank as a fault -> kill + relaunch")
    p.add_argument("--checkpoint_dir",
                   default=os.environ.get("PADDLE_CHECKPOINT_DIR"),
                   help="checkpoint root holding step_N dirs; each round "
                        "exports the newest COMMITTED one as "
                        "PADDLE_RESUME_CHECKPOINT / PADDLE_RESUME_STEP")
    p.add_argument("script", help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args()


def _spawn(rank, world, args, extra_env=None):
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_RANK": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_NNODES": str(world),
        "PADDLE_WORLD_SIZE": str(world),
    })
    if args.master:
        env["PADDLE_MASTER"] = args.master
        env.setdefault("MASTER_ADDR", args.master.split(":")[0])
        if ":" in args.master:
            env.setdefault("MASTER_PORT", args.master.split(":")[1])
    if args.devices is not None:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    if extra_env:
        env.update(extra_env)
    os.makedirs(args.log_dir, exist_ok=True)
    logf = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "a")
    proc = subprocess.Popen([sys.executable, args.script] +
                            args.script_args, env=env, stdout=logf,
                            stderr=subprocess.STDOUT)
    return proc, logf


def _free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dump_worker_log(args, local, ret, logf, tail_lines=40):
    """The failed rank's log tail on the launcher's stderr."""
    logf.flush()
    path = os.path.join(args.log_dir, f"workerlog.{local}")
    print(f"paddle_tpu_torch.launch: rank {local} exited rc={ret}; "
          f"last {tail_lines} lines of {path}:", file=sys.stderr)
    try:
        with open(path) as f:
            for line in f.readlines()[-tail_lines:]:
                print(f"  [rank {local}] {line.rstrip()}", file=sys.stderr)
    except OSError as e:
        print(f"  (log unreadable: {e})", file=sys.stderr)


def _terminate_all(procs, grace=5.0):
    for proc, _ in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    end = time.time() + grace
    for proc, logf in procs:
        try:
            proc.wait(timeout=max(0.1, end - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        logf.close()


def _run_round(procs, args, manager, shutdown):
    """Poll every worker until the round ends. Returns ``(outcome,
    bad_ranks)``: outcome ``ok``, ``failed``, ``stale``, ``preempted`` or
    ``shutdown``; ``bad_ranks`` are the crashed or stale local ranks
    (the slots a shrinking relaunch takes as lost)."""
    # a worker that hangs before its first heartbeat is caught too
    register_deadline = time.time() + max(5 * args.heartbeat_timeout, 30.0)
    while True:
        if shutdown["flag"]:
            return "shutdown", []
        alive = False
        done_ok = set()
        preempted = []
        failed = []
        for local, (proc, logf) in enumerate(procs):
            ret = proc.poll()
            if ret is None:
                alive = True
            elif ret == PREEMPTED_EXIT_CODE:
                preempted.append(local)
            elif ret != 0:
                # every rank lost in the round counts, or a shrinking
                # relaunch undercounts the lost capacity
                _dump_worker_log(args, local, ret, logf)
                failed.append(local)
            else:
                done_ok.add(local)
        if failed:
            return "failed", failed
        if preempted:
            # a partial preemption ends the round too: the peers would
            # block at their next collective; the caller SIGTERMs them
            print(f"paddle_tpu_torch.launch: ranks {preempted} exited on "
                  f"clean preemption (rc={PREEMPTED_EXIT_CODE})",
                  file=sys.stderr)
            if not alive:
                for _, logf in procs:
                    logf.close()
            return "preempted", []
        if not alive:
            for _, logf in procs:
                logf.close()
            return "ok", []
        if manager is not None:
            from ..fleet.elastic.manager import ElasticStatus
            # workers that exited cleanly stop heartbeating legitimately
            status, bad = manager.watch(ignore=done_ok)
            if status is ElasticStatus.STALE:
                print(f"paddle_tpu_torch.launch: stale heartbeats from "
                      f"ranks {bad}", file=sys.stderr)
                return "stale", list(bad)
            if (status is ElasticStatus.INCOMPLETE
                    and time.time() > register_deadline):
                print(f"paddle_tpu_torch.launch: ranks {bad} never "
                      f"registered a heartbeat", file=sys.stderr)
                return "stale", list(bad)
        time.sleep(0.2)


def launch_main():
    args = _parse()
    if args.min_nproc_per_node > 0 and args.nnodes > 1:
        # shrinking per launcher would leave the nodes disagreeing on
        # the world size and the ranks
        print("paddle_tpu_torch.launch: --min_nproc_per_node is "
              "single-node only (per-launcher shrinking is uncoordinated "
              "across nodes); ignoring it", file=sys.stderr)
        args.min_nproc_per_node = 0
    restarts = 0
    preempt_restarts = 0
    nproc = args.nproc_per_node
    manager = None
    hb_dir = None
    shutdown = {"flag": False}

    def _on_term(signum, frame):
        shutdown["flag"] = True

    try:
        prev_term = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:      # not the main thread (embedded use)
        prev_term = None
    if args.heartbeat_timeout > 0:
        from ..fleet.elastic.manager import ElasticManager
        hb_dir = os.path.join(args.log_dir, "heartbeat")
        os.makedirs(hb_dir, exist_ok=True)
        manager = ElasticManager(nproc, directory=hb_dir,
                                 timeout=args.heartbeat_timeout)
    try:
        while True:
            procs = []
            world = args.nnodes * nproc
            base = args.rank * nproc
            if manager is not None:
                manager.world_size = nproc
                manager.reset()
            resume_env = {
                "PADDLE_RESTART_ROUND": str(restarts + preempt_restarts),
                "PADDLE_PREEMPT_GRACE_S": str(args.grace),
            }
            if args.checkpoint_dir:
                from ..fleet.elastic.manager import (checkpoint_step,
                                                     latest_valid_checkpoint)
                ck = latest_valid_checkpoint(args.checkpoint_dir)
                if ck is not None:
                    resume_env.update({
                        "PADDLE_RESUME_CHECKPOINT": ck,
                        "PADDLE_RESUME_STEP": str(checkpoint_step(ck)),
                    })
                    print(f"paddle_tpu_torch.launch: resuming from {ck}",
                          flush=True)
            if not args.master and args.nnodes == 1 and world > 1:
                # one host: each round's ranks meet at a fresh local port
                resume_env["PADDLE_MASTER"] = f"127.0.0.1:{_free_port()}"
            for local in range(nproc):
                extra = {"PADDLE_LOCAL_RANK": str(local),
                         "PADDLE_LOCAL_SIZE": str(nproc)}
                extra.update(resume_env)
                if hb_dir is not None:
                    extra["PADDLE_ELASTIC_HEARTBEAT_DIR"] = hb_dir
                    extra["PADDLE_ELASTIC_HEARTBEAT_RANK"] = str(local)
                procs.append(_spawn(base + local, world, args, extra))
            try:
                outcome, bad = _run_round(procs, args, manager, shutdown)
            except KeyboardInterrupt:
                _terminate_all(procs)
                raise
            if outcome == "ok":
                print("paddle_tpu_torch.launch: all workers exited cleanly",
                      flush=True)
                return 0
            if outcome == "shutdown":
                print("paddle_tpu_torch.launch: SIGTERM received; "
                      f"forwarding to workers with a {args.grace}s grace "
                      "window", file=sys.stderr)
                _terminate_all(procs, grace=args.grace)
                return PREEMPTED_EXIT_CODE
            _terminate_all(procs, grace=args.grace)
            if outcome == "preempted":
                if preempt_restarts >= args.max_preempt_restarts:
                    print("paddle_tpu_torch.launch: preempt restarts "
                          "exhausted", file=sys.stderr)
                    return 1
                preempt_restarts += 1
                budget = (f"preempt {preempt_restarts}/"
                          f"{args.max_preempt_restarts}")
            else:
                if restarts >= args.max_restarts:
                    print(f"paddle_tpu_torch.launch: worker {outcome}; "
                          f"restarts exhausted", file=sys.stderr)
                    return 1
                restarts += 1
                budget = f"{restarts}/{args.max_restarts}"
                if args.min_nproc_per_node > 0 and bad:
                    survivors = max(args.min_nproc_per_node,
                                    nproc - len(bad))
                    if survivors != nproc:
                        print(f"paddle_tpu_torch.launch: shrinking "
                              f"nproc_per_node {nproc} -> {survivors} "
                              f"(lost ranks {bad})", file=sys.stderr)
                        nproc = survivors
            delay = _backoff(args, restarts + preempt_restarts)
            print(f"paddle_tpu_torch.launch: worker {outcome}; relaunching "
                  f"({budget}) after {delay:.0f}s", file=sys.stderr)
            _interruptible_sleep(delay, shutdown)
            if shutdown["flag"]:
                return PREEMPTED_EXIT_CODE
    finally:
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except (ValueError, TypeError):
                pass


def _backoff(args, attempt):
    """base * 2^(attempt-1), capped at --max_backoff; a zero base stays
    zero."""
    base = float(args.elastic_timeout)
    if base <= 0:
        return 0.0
    return min(base * (2.0 ** max(0, attempt - 1)), args.max_backoff)


def _interruptible_sleep(seconds, shutdown):
    end = time.time() + seconds
    while time.time() < end and not shutdown["flag"]:
        time.sleep(min(0.2, max(0.0, end - time.time())))


if __name__ == "__main__":
    sys.exit(launch_main())
