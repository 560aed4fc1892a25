"""The file-op and call-site plans of the port's ``testing.FaultInjector``
against the port's checkpoints: the injected-fault cases of
tests/test_checkpoint_fault.py (ENOSPC then a retry, a fault that does
not clear, a silent short write, a transient read fault, SIGKILL between
the shard writes and the commit) and the call plans (raise after N
calls, a crash inside a callable, a crash at an open). The injector
restores everything it patched."""

import builtins
import errno
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.testing import FaultInjector

pytestmark = pytest.mark.fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO)


def _sd(v):
    return {"w": torch.full((4, 4), float(v)), "step": v}


def _loaded(path):
    target = {"w": torch.zeros(4, 4)}
    ckpt.load_state_dict(target, str(path))
    return target["w"]


def test_enospc_then_retry(tmp_path):
    path = tmp_path / "ck"
    with FaultInjector() as fi:
        plan = fi.fail_write("w.r0.s0.npy", errno_=errno.ENOSPC,
                             after_bytes=16)
        ckpt.save_state_dict(_sd(7), str(path))
    assert plan.fired == 1 and ckpt.is_committed(str(path))
    assert torch.equal(_loaded(path), torch.full((4, 4), 7.0))


def test_persistent_enospc_fails_without_commit(tmp_path):
    path = tmp_path / "ck"
    with FaultInjector() as fi:
        fi.fail_write("w.r0.s0.npy", errno_=errno.ENOSPC, times=100)
        with pytest.raises(OSError) as ei:
            ckpt.save_state_dict(_sd(7), str(path))
        assert ei.value.errno == errno.ENOSPC
        assert fi.fires() == 4      # the attempt and 3 retries
    assert not os.path.exists(path)
    assert ckpt.latest_valid_checkpoint(str(tmp_path)) is None


def test_silent_short_write_caught_by_size_check(tmp_path):
    path = tmp_path / "ck"
    with FaultInjector() as fi:
        plan = fi.truncate_write("w.r0.s0.npy", after_bytes=32)
        ckpt.save_state_dict(_sd(9), str(path))
    assert plan.fired == 1
    assert torch.equal(_loaded(path), torch.full((4, 4), 9.0))


def test_transient_read_fault_retried_on_load(tmp_path):
    path = tmp_path / "ck"
    ckpt.save_state_dict(_sd(3), str(path))
    with FaultInjector() as fi:
        plan = fi.fail_read("w.r0.s0.npy", errno_=errno.EIO)
        w = _loaded(path)
    assert plan.fired == 1 and torch.equal(w, torch.full((4, 4), 3.0))


def test_fail_call_after_calls_and_restore(tmp_path):
    """A call plan fires once more than ``after_calls`` calls went by;
    uninstall restores the callable and ``open``."""
    from paddle_tpu_torch.optimizer import SGD
    real_open, real_step = builtins.open, SGD.step
    net = torch.nn.Linear(2, 2)
    opt = SGD(0.1, parameters=net.parameters())
    with FaultInjector() as fi:
        plan = fi.fail_call("paddle_tpu_torch.optimizer.SGD.step",
                            errno_=errno.EIO, after_calls=2)
        opt.step()
        opt.step()
        with pytest.raises(OSError, match="fault injected"):
            opt.step()
        opt.step()                  # times=1: fired once
    assert plan.fired == 1 and plan.calls == 4
    assert builtins.open is real_open and SGD.step is real_step
    bad = FaultInjector()
    bad.fail_call("no_such_module_x.f")
    try:
        with pytest.raises(ValueError, match="cannot resolve"):
            bad.install()
    finally:
        bad.uninstall()
    assert builtins.open is real_open


CRASHER = """
import os, sys
from paddle_tpu_torch.testing import FaultInjector
root, how = sys.argv[1], sys.argv[2]
fi = FaultInjector()
if how == "call":
    fi.crash_call("os.path.join", after_calls=1)
else:
    fi.crash("victim", op="open")
fi.install()
os.path.join(root, "a")
open(os.path.join(root, "victim"), "w")
open(os.path.join(root, "UNREACHABLE"), "w")
"""


@pytest.mark.parametrize("how", ["call", "open"])
def test_crash_plans_end_the_process_with_41(tmp_path, how):
    script = tmp_path / "crasher.py"
    script.write_text(CRASHER)
    r = subprocess.run([sys.executable, str(script), str(tmp_path), how],
                       env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 41, r.stderr
    assert not (tmp_path / "UNREACHABLE").exists()


CRASH_MID_SAVE = """
import os, sys
import torch
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.testing import FaultInjector
root, marker = sys.argv[1], sys.argv[2]
sd = lambda v: {"w": torch.full((4, 4), float(v)), "step": v}
ckpt.save_state_dict(sd(1), os.path.join(root, "step_1"))
fi = FaultInjector()
fi.pause("COMMITTED", op="open", marker=marker)
fi.install()
ckpt.save_state_dict(sd(2), os.path.join(root, "step_2"))
open(os.path.join(root, "UNREACHABLE"), "w").write("save returned")
"""


def test_sigkill_between_shard_write_and_commit(tmp_path):
    script = tmp_path / "crash_mid_save.py"
    script.write_text(CRASH_MID_SAVE)
    root = tmp_path / "ckpts"
    root.mkdir()
    marker = str(tmp_path / "paused")
    with open(tmp_path / "child.log", "w") as log:
        proc = subprocess.Popen([sys.executable, str(script), str(root),
                                 marker], env=ENV, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while not os.path.exists(marker):
                assert proc.poll() is None, \
                    (tmp_path / "child.log").read_text()
                assert time.time() < deadline, "never reached the commit"
                time.sleep(0.05)
            proc.kill()
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert not (root / "UNREACHABLE").exists()
    assert not (root / "step_2").exists()
    torn = [n for n in os.listdir(root) if n.startswith("step_2.tmp-")]
    assert torn and not ckpt.is_committed(str(root / torn[0]))
    with pytest.raises(ckpt.CheckpointNotCommittedError):
        ckpt.load_state_dict({"w": torch.zeros(4, 4)}, str(root / torn[0]))
    best = ckpt.latest_valid_checkpoint(str(root))
    assert os.path.basename(best) == "step_1"
    assert torch.equal(_loaded(best), torch.ones(4, 4))
    assert np.asarray(ckpt.load_values(best)["step"]) == 1
