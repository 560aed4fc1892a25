"""The port's elastic launcher and manager: the counterparts of
tests/test_elastic.py, against ``python -m
paddle_tpu_torch.distributed.launch`` (subprocess workers that crash,
hang, get preempted or exit cleanly) and the port's
``distributed.fleet.elastic``. The launcher imports neither torch nor
jax."""

import argparse
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.fleet.elastic import (
    PREEMPTED_EXIT_CODE, ElasticManager, ElasticStatus, PreemptionGuard,
    checkpoint_step, latest_checkpoint, latest_valid_checkpoint,
    start_heartbeat, stop_heartbeat)
from paddle_tpu_torch.distributed.fleet.elastic.manager import _beat_once
from paddle_tpu_torch.distributed.launch.main import _backoff, _run_round

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
ENV = dict(os.environ, PYTHONPATH=REPO)


def _launch(tmp_path, script_text, *flags, args=(), name="w.py"):
    script = tmp_path / name
    script.write_text(script_text)
    return subprocess.run(
        LAUNCH + ["--elastic_timeout", "0", "--log_dir",
                  str(tmp_path / "log"), *flags, str(script), *args],
        env=ENV, capture_output=True, text=True, timeout=120)


# ---- the manager ----------------------------------------------------------

def test_heartbeat_and_watch(tmp_path):
    d = str(tmp_path)
    mgr = ElasticManager(2, directory=d, timeout=0.5)
    status, missing = mgr.watch()
    assert status is ElasticStatus.INCOMPLETE and missing == [0, 1]
    start_heartbeat(0, directory=d, interval=0.1)
    status, missing = mgr.watch()
    assert status is ElasticStatus.INCOMPLETE and missing == [1]
    start_heartbeat(1, directory=d, interval=0.1)  # replaces rank 0's
    assert mgr.wait_all_registered(timeout=5.0)
    assert mgr.watch()[0] is ElasticStatus.HEALTHY
    time.sleep(0.8)
    status, stale = mgr.watch()
    assert status is ElasticStatus.STALE and stale == [0]
    stop_heartbeat()
    mgr.reset()
    assert mgr.watch()[0] is ElasticStatus.INCOMPLETE


def test_heartbeat_store_backend():
    """A ``torch.distributed.TCPStore`` as the registry: a missing key
    reads as missing (``check``), not as a wait."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    mgr = ElasticManager(1, store=store, timeout=5.0)
    assert mgr.watch()[0] is ElasticStatus.INCOMPLETE
    _beat_once(0, store=store)
    assert mgr.watch()[0] is ElasticStatus.HEALTHY
    mgr.reset()
    assert mgr.watch()[0] is ElasticStatus.INCOMPLETE


def test_watch_ignores_exited_ranks(tmp_path):
    d = str(tmp_path)
    mgr = ElasticManager(2, directory=d, timeout=0.3)
    _beat_once(0, directory=d)
    _beat_once(1, directory=d)
    time.sleep(0.5)
    _beat_once(1, directory=d)  # rank 1 alive; rank 0 exited
    assert mgr.watch()[0] is ElasticStatus.STALE
    status, bad = mgr.watch(ignore={0})
    assert status is ElasticStatus.HEALTHY, bad


def test_start_heartbeat_rank_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_HEARTBEAT_RANK", "3")
    monkeypatch.setenv("PADDLE_ELASTIC_HEARTBEAT_DIR", str(tmp_path))
    assert start_heartbeat(interval=0.2)
    try:
        assert os.path.exists(tmp_path / "heartbeat.3")
    finally:
        stop_heartbeat()
    monkeypatch.delenv("PADDLE_ELASTIC_HEARTBEAT_DIR")
    assert start_heartbeat() is False     # no registry to beat into


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "nope")) is None
    for s in (10, 200, 30):
        os.makedirs(tmp_path / f"step_{s}")
    os.makedirs(tmp_path / "step_999.tmp")
    os.makedirs(tmp_path / "step_998.tmp-abc12")
    os.makedirs(tmp_path / "unrelated")
    best = latest_checkpoint(str(tmp_path))
    assert os.path.basename(best) == "step_200"
    assert checkpoint_step(best) == 200
    assert checkpoint_step("/x/unrelated") == -1


def _two_checkpoints(root, torn="step_20"):
    sd = {"w": torch.ones(4)}
    ckpt.save_state_dict(sd, str(root / "step_10"))
    ckpt.save_state_dict(sd, str(root / torn))
    os.remove(root / torn / "COMMITTED")      # torn by a crash


def test_latest_valid_checkpoint_skips_torn_saves(tmp_path):
    _two_checkpoints(tmp_path)
    os.makedirs(tmp_path / "step_30.tmp-dead")
    assert os.path.basename(latest_checkpoint(str(tmp_path))) == "step_20"
    assert os.path.basename(
        latest_valid_checkpoint(str(tmp_path))) == "step_10"
    assert latest_valid_checkpoint(str(tmp_path / "nope")) is None


# ---- the launcher ---------------------------------------------------------

CRASH_ONCE = """
import os, sys
marker = sys.argv[1]
if not os.path.exists(marker):
    open(marker, "w").write("x")
    sys.exit(1)
open(marker + ".done", "w").write("ok")
"""


def test_launcher_restarts_after_crash(tmp_path):
    marker = str(tmp_path / "marker")
    r = _launch(tmp_path, CRASH_ONCE, "--max_restarts", "2", args=[marker])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(marker + ".done")
    assert "relaunching (1/2)" in r.stderr


def test_launcher_exhausts_restarts(tmp_path):
    r = _launch(tmp_path, "import sys; sys.exit(3)", "--max_restarts", "1")
    assert r.returncode == 1
    assert "restarts exhausted" in r.stderr


RESUME_PROBE = """
import os, sys
with open(sys.argv[1], "w") as f:
    f.write(os.environ.get("PADDLE_RESUME_CHECKPOINT", "NONE") + "\\n")
    f.write(os.environ.get("PADDLE_RESUME_STEP", "NONE") + "\\n")
    f.write(os.environ.get("PADDLE_RESTART_ROUND", "NONE") + "\\n")
    f.write(os.environ.get("CUDA_VISIBLE_DEVICES", "NONE"))
"""


def test_launcher_exports_validated_resume_env(tmp_path):
    root = tmp_path / "ckpts"
    _two_checkpoints(root, torn="step_29")
    out = tmp_path / "probe.out"
    r = _launch(tmp_path, RESUME_PROBE, "--max_restarts", "0",
                "--checkpoint_dir", str(root), "--devices", "0",
                args=[str(out)])
    assert r.returncode == 0, r.stderr
    assert "resuming from" in r.stdout
    path, step, rnd, devices = out.read_text().splitlines()
    assert os.path.basename(path) == "step_10" and step == "10"
    assert rnd == "0" and devices == "0"


def test_launcher_resume_env_absent_without_checkpoints(tmp_path):
    out = tmp_path / "probe.out"
    r = _launch(tmp_path, RESUME_PROBE, "--max_restarts", "0",
                "--checkpoint_dir", str(tmp_path / "empty"),
                args=[str(out)])
    assert r.returncode == 0, r.stderr
    assert out.read_text().splitlines()[0] == "NONE"


PREEMPT_ONCE = """
import os, sys
from paddle_tpu_torch.distributed.fleet.elastic.preempt import \\
    PREEMPTED_EXIT_CODE
marker = sys.argv[1]
if not os.path.exists(marker):
    open(marker, "w").write("x")
    sys.exit(PREEMPTED_EXIT_CODE)
open(marker + ".done", "w").write(os.environ.get("PADDLE_RESTART_ROUND", "?"))
"""


def test_preempted_exit_does_not_burn_crash_budget(tmp_path):
    marker = str(tmp_path / "marker")
    r = _launch(tmp_path, PREEMPT_ONCE, "--max_restarts", "0",
                args=[marker])
    assert r.returncode == 0, r.stderr
    assert "clean preemption" in r.stderr
    assert "preempt 1/16" in r.stderr
    assert open(marker + ".done").read() == "1"


def test_preempt_restart_budget_exhausted(tmp_path):
    r = _launch(tmp_path,
                "import sys\nfrom paddle_tpu_torch.distributed.fleet."
                "elastic import PREEMPTED_EXIT_CODE\n"
                "sys.exit(PREEMPTED_EXIT_CODE)\n",
                "--max_restarts", "0", "--max_preempt_restarts", "2")
    assert r.returncode == 1
    assert "preempt restarts exhausted" in r.stderr
    assert r.stderr.count("relaunching (preempt") == 2


UNCAUGHT_PREEMPTED = """
import os, sys
from paddle_tpu_torch.distributed.fleet.elastic import (Preempted,
                                                        PreemptionGuard)
marker = sys.argv[1]
if not os.path.exists(marker):
    open(marker, "w").write("x")
    PreemptionGuard().install()      # chains the Preempted excepthook
    raise Preempted("preempted mid-run", checkpoint="/ck", epoch=1, step=2)
open(marker + ".done", "w").write("ok")
"""


def test_uncaught_preempted_exits_with_preempt_code(tmp_path):
    marker = str(tmp_path / "marker")
    r = _launch(tmp_path, UNCAUGHT_PREEMPTED, "--max_restarts", "0",
                args=[marker])
    assert r.returncode == 0, r.stderr
    assert "clean preemption" in r.stderr
    assert os.path.exists(marker + ".done")
    log = (tmp_path / "log" / "workerlog.0").read_text()
    assert "exiting 75 (clean preemption)" in log


PARTIAL_PREEMPT = """
import os, sys, time
from paddle_tpu_torch.distributed.fleet.elastic import PREEMPTED_EXIT_CODE
marker, out = sys.argv[1], sys.argv[2]
rank = int(os.environ["PADDLE_TRAINER_ID"])
if not os.path.exists(marker):
    if rank == 0:
        open(marker, "w").write("x")
        sys.exit(PREEMPTED_EXIT_CODE)
    time.sleep(300)
with open(out + f".{rank}", "w") as f:
    f.write("ok")
"""


def test_partial_preemption_ends_the_round(tmp_path):
    marker, out = str(tmp_path / "marker"), str(tmp_path / "out")
    r = _launch(tmp_path, PARTIAL_PREEMPT, "--nproc_per_node", "2",
                "--max_restarts", "0", "--grace", "5", args=[marker, out])
    assert r.returncode == 0, r.stderr
    assert "clean preemption" in r.stderr
    assert os.path.exists(out + ".0") and os.path.exists(out + ".1")


def test_min_nproc_ignored_multinode(tmp_path):
    r = _launch(tmp_path, "pass\n", "--nnodes", "2", "--rank", "0",
                "--min_nproc_per_node", "1", "--max_restarts", "0")
    assert r.returncode == 0, r.stderr
    assert "single-node only" in r.stderr


SHRINK_PROBE = """
import os, sys, time
world = int(os.environ["PADDLE_TRAINERS_NUM"])
rank = int(os.environ["PADDLE_TRAINER_ID"])
if world == 2:
    if rank == 1:
        sys.exit(9)
    time.sleep(60)
with open(sys.argv[1], "w") as f:
    f.write(f"world={world}")
"""


def test_relaunch_shrinks_to_surviving_world(tmp_path):
    out = str(tmp_path / "out")
    r = _launch(tmp_path, SHRINK_PROBE, "--nproc_per_node", "2",
                "--min_nproc_per_node", "1", "--max_restarts", "1",
                args=[out])
    assert r.returncode == 0, r.stderr
    assert "shrinking nproc_per_node 2 -> 1" in r.stderr
    assert open(out).read() == "world=1"


def test_run_round_counts_all_simultaneous_failures(tmp_path):
    class FakeProc:
        def __init__(self, ret):
            self.ret = ret

        def poll(self):
            return self.ret

    class FakeLog:
        def flush(self):
            pass

        def close(self):
            pass

    args = argparse.Namespace(log_dir=str(tmp_path / "log"),
                              heartbeat_timeout=0.0)
    procs = [(FakeProc(9), FakeLog()), (FakeProc(None), FakeLog()),
             (FakeProc(7), FakeLog())]
    assert _run_round(procs, args, None, {"flag": False}) == \
        ("failed", [0, 2])


HANG_ONCE = """
import os, sys, time
from paddle_tpu_torch.distributed.fleet.elastic import (start_heartbeat,
                                                        stop_heartbeat)
marker = sys.argv[1]
start_heartbeat(interval=0.1)
if not os.path.exists(marker):
    open(marker, "w").write("x")
    stop_heartbeat()     # the heartbeat stops; the process hangs
    time.sleep(300)
open(marker + ".done", "w").write("ok")
"""


def test_launcher_detects_hung_worker(tmp_path):
    """A worker whose heartbeat stops (but which does not exit) is
    killed and relaunched on the crash budget."""
    marker = str(tmp_path / "marker")
    r = _launch(tmp_path, HANG_ONCE, "--max_restarts", "1",
                "--heartbeat_timeout", "2.0", "--grace", "2",
                args=[marker])
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert os.path.exists(marker + ".done")
    assert "stale heartbeats" in r.stderr
    assert "relaunching (1/1)" in r.stderr


TERM_FORWARD = """
import os, sys, time
from paddle_tpu_torch.distributed.fleet.elastic import (
    PREEMPTED_EXIT_CODE, PreemptionGuard)
marker = sys.argv[1]
guard = PreemptionGuard().install()
open(marker, "w").write("started")
for _ in range(600):
    if guard.requested():
        open(marker + ".term", "w").write(str(guard.grace_s))
        sys.exit(PREEMPTED_EXIT_CODE)
    time.sleep(0.1)
sys.exit(3)
"""


def test_launcher_forwards_sigterm_with_grace(tmp_path):
    script = tmp_path / "term_forward.py"
    script.write_text(TERM_FORWARD)
    marker = str(tmp_path / "marker")
    proc = subprocess.Popen(
        LAUNCH + ["--max_restarts", "3", "--elastic_timeout", "0",
                  "--grace", "20", "--log_dir", str(tmp_path / "log"),
                  str(script), marker],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while not os.path.exists(marker):
            assert proc.poll() is None, proc.communicate()
            assert time.time() < deadline, "worker never started"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == PREEMPTED_EXIT_CODE, err
    assert "forwarding to workers" in err.replace("\n", " ")
    # the worker saw the forwarded signal, with the launcher's grace
    assert open(marker + ".term").read() == "20.0"


def test_launcher_dumps_failed_worker_log(tmp_path):
    r = _launch(tmp_path,
                "print('useful diagnostic line A')\n"
                "print('useful diagnostic line B')\n"
                "raise RuntimeError('worker exploded: cuda_oom_equivalent')\n",
                "--max_restarts", "0")
    assert r.returncode == 1
    assert "exited rc=1" in r.stderr
    assert "worker exploded: cuda_oom_equivalent" in r.stderr
    assert "[rank 0]" in r.stderr
    assert (tmp_path / "log" / "workerlog.0").exists()


def test_launcher_process_imports_neither_torch_nor_jax(tmp_path):
    """The launcher, through a round with a checkpoint lookup and the
    heartbeat watchdog, loads no torch, jax or numpy; nor do the
    package's lazy names (``seed``, the RNG state, ``summary``) and the
    profiler package when imported."""
    root = tmp_path / "ckpts"
    _two_checkpoints(root)
    script = tmp_path / "beat.py"
    script.write_text(
        "from paddle_tpu_torch.distributed.fleet.elastic import "
        "start_heartbeat\nimport time\nstart_heartbeat(interval=0.05)\n"
        "time.sleep(0.5)\n")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['launch', '--elastic_timeout', '0', '--log_dir', "
        f"{str(tmp_path / 'log')!r}, '--checkpoint_dir', {str(root)!r}, "
        f"'--heartbeat_timeout', '5', {str(script)!r}]\n"
        "try:\n"
        "    runpy.run_module('paddle_tpu_torch.distributed.launch', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import paddle_tpu_torch, paddle_tpu_torch.profiler\n"
        "lazy = {'seed', 'get_rng_state', 'set_rng_state', 'summary'}\n"
        "assert lazy <= set(paddle_tpu_torch._LAZY), paddle_tpu_torch._LAZY\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'numpy', 'paddle_tpu'))\n"
        "print('LOADED', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout, r.stdout
    assert "resuming from" in r.stdout


# ---- a preemptible fit under the launcher ---------------------------------

FIT_WORKER = """
import json, os, sys
import numpy as np
import torch
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import TensorDataset

out = sys.argv[1]
x = torch.from_numpy(np.random.RandomState(0).randn(16, 8).astype("f4"))
net = torch.nn.Linear(8, 8)
torch.manual_seed(0)
with torch.no_grad():
    net.weight.copy_(torch.randn(8, 8))
    net.bias.zero_()
m = Model(net)
opt = optimizer.Momentum(0.05, parameters=net.parameters())
if os.environ.get("PADDLE_RESTART_ROUND", "0") == "0":
    real_step = opt.step
    def step():
        real_step()
        if opt._step_count == 6:      # step 1 of epoch 1
            os.kill(os.getpid(), 15)
    opt.step = step
m.prepare(opt, torch.nn.MSELoss())
m.fit(TensorDataset([x, x]), batch_size=4, epochs=3, shuffle=True,
      verbose=0, save_dir=os.path.join(out, "ck"), resume=True)
with open(os.path.join(out, "final.json"), "w") as f:
    json.dump({"w": net.weight.detach().numpy().tolist(),
               "steps": opt._step_count}, f)
"""


def test_preemptible_fit_under_the_launcher(tmp_path):
    """A real SIGTERM mid-epoch: fit commits the emergency checkpoint, the
    uncaught Preempted exits 75, the launcher relaunches with the
    committed checkpoint, and the resumed run ends where an uninterrupted
    one does."""
    r = _launch(tmp_path, FIT_WORKER, "--max_restarts", "0",
                "--max_preempt_restarts", "1",
                "--checkpoint_dir", str(tmp_path / "ck"),
                args=[str(tmp_path)])
    assert r.returncode == 0, r.stderr
    assert "clean preemption" in r.stderr
    assert r.stderr.count("relaunching (preempt 1/1)") == 1
    import json
    got = json.loads((tmp_path / "final.json").read_text())
    assert got["steps"] == 12
    ledger = json.loads((tmp_path / "ck" / "goodput.json").read_text())
    assert sorted(ledger["rounds"]) == ["0", "1"]
    assert ledger["rounds"]["0"]["lost"]["emergency_save"] > 0
    assert ledger["rounds"]["1"]["lost"]["reshard"] > 0
    # the same script without the signal, in this process's terms
    ref = tmp_path / "ref"
    ref.mkdir()
    r2 = subprocess.run([sys.executable, str(tmp_path / "w.py"), str(ref)],
                        env=dict(ENV, PADDLE_RESTART_ROUND="1"),
                        capture_output=True, text=True, timeout=120)
    assert r2.returncode == 0, r2.stderr
    want = json.loads((ref / "final.json").read_text())
    assert np.array_equal(np.asarray(got["w"]), np.asarray(want["w"]))


# ---- the guard and the excepthook -----------------------------------------

def test_guard_request_remaining_and_thread_inertness(monkeypatch):
    monkeypatch.setenv("PADDLE_PREEMPT_GRACE_S", "12")
    guard = PreemptionGuard()
    assert guard.grace_s == 12.0
    assert not guard.requested() and guard.remaining() == float("inf")
    guard.request(grace_s=0.5)
    assert guard.requested() and 1.0 <= guard.remaining() <= 1.0 + 1e-6
    guard.reset()
    assert not guard.requested()
    out = {}

    def off_main():
        g = PreemptionGuard().install()     # inert: not the main thread
        out["installed"] = g._installed
        out["requested"] = g.request().requested()

    t = threading.Thread(target=off_main)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and out == {"installed": False,
                                        "requested": True}
    with PreemptionGuard() as g:           # the main thread claims it
        assert signal.getsignal(signal.SIGTERM) == g._on_signal
    assert signal.getsignal(signal.SIGTERM) != g._on_signal


THIRD_SIGTERM = """
import os, signal, sys, time
from paddle_tpu_torch.distributed.fleet.elastic import PreemptionGuard
guard = PreemptionGuard().install()
for _ in range(2):
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.05)
assert guard.requested() and guard._count == 2     # recorded, not exited
open(sys.argv[1], "w").write("two")
os.kill(os.getpid(), signal.SIGTERM)              # the third: out now
time.sleep(5)
sys.exit(3)
"""


def test_third_sigterm_forces_exit(tmp_path):
    script = tmp_path / "third.py"
    script.write_text(THIRD_SIGTERM)
    marker = tmp_path / "two"
    r = subprocess.run([sys.executable, str(script), str(marker)], env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 128 + signal.SIGTERM, r.stderr
    assert marker.read_text() == "two"


DUMPED = """
import sys
from paddle_tpu_torch.distributed.fleet.elastic import (Preempted,
                                                        PreemptionGuard)
from paddle_tpu_torch.profiler import flight_recorder
flight_recorder.install(bundle_dir=sys.argv[1])
PreemptionGuard().install()
raise Preempted("preempted mid-run", checkpoint="/ck", epoch=1, step=2)
"""


def test_uncaught_preempted_dumps_a_bundle_then_exits_75(tmp_path):
    script = tmp_path / "dumped.py"
    script.write_text(DUMPED)
    r = subprocess.run([sys.executable, str(script), str(tmp_path)],
                       env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == PREEMPTED_EXIT_CODE == 75, r.stderr
    import json
    bundles = [n for n in os.listdir(tmp_path) if n.endswith(".json")]
    assert bundles, os.listdir(tmp_path)
    doc = json.loads((tmp_path / bundles[0]).read_text())
    assert "preempted mid-run" in json.dumps(doc)


def test_backoff_doubles_to_its_cap():
    args = argparse.Namespace(elastic_timeout=2, max_backoff=10.0)
    assert [_backoff(args, a) for a in (1, 2, 3, 4, 5)] == \
        [2.0, 4.0, 8.0, 10.0, 10.0]
    args.elastic_timeout = 0
    assert _backoff(args, 7) == 0.0
