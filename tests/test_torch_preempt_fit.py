"""Preemption inside the port's ``hapi.Model.fit``: the cases of
tests/test_preempt_fit.py, single-device and across layouts.

A guard that trips mid-epoch (``_TripAtStep``) or a real SIGTERM (the
``preempt`` fault plan) stops ``fit`` at the next step boundary; it
commits the emergency checkpoint and raises ``Preempted`` with the
epoch-relative step; a new ``Model`` from other weights resumes it.
The resumed run's final state equals the port's uninterrupted run bit
for bit, and the JAX package's uninterrupted run from the same weights
within rtol 1e-5 / atol 1e-6 (f32; the JAX test's own tolerance), for
momentum, Adam with a ``GradScaler``, both epoch loops, and a general
``Dataset`` shuffled through two loader workers.

Across layouts (gloo ranks of ``torch_dist_pool.RankPool`` running
``torch_ckpt_cases.preempt_fit``; the JAX test's mesh matrix with the
port's layouts): dp 2 -> 1, mp 2 with dp 2 -> mp 2 with dp 1, Adam slots
with a ``GradScaler`` at mp 2 -> mp 1, ZeRO stage 2 -> 1 rank. The guard
trips after step 6 on every rank, the emergency checkpoint commits
through the barrier, the smaller layout resumes with ``fit(resume=
True)`` and its final state equals the JAX uninterrupted run's within
the same rtol 1e-5 / atol 1e-6. The scaler's state survives the reshard
exactly, and with a dead peer the emergency save fails uncommitted
within the guard's grace.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.hapi import Model as JModel

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.fleet.elastic import (Preempted,
                                                        PreemptionGuard)
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.profiler import trace as ttrace
from paddle_tpu_torch.testing import FaultInjector
from torch_dist_pool import RankPool
from torch_io_data import ArrayDataset

torch.set_num_threads(1)

EPOCHS = 3
STEPS_PER_EPOCH = 4   # 16 rows / batch 4
X = np.random.RandomState(0).randn(16, 8).astype("float32")
Y = np.random.RandomState(1).randn(16, 8).astype("float32")


def _data(general=False):
    if general:
        return ArrayDataset(X, Y)
    return TensorDataset([torch.from_numpy(X), torch.from_numpy(Y)])


def _jax_weights(seed):
    paddle.seed(seed)
    net = jnn.Linear(8, 8)
    return net, np.asarray(net.weight.numpy()), np.asarray(net.bias.numpy())


def _scaler():
    return dict(init_loss_scaling=512.0, incr_every_n_steps=3,
                use_dynamic_loss_scaling=True)


def _model(seed, opt="momentum", scaler=False):
    """The port's Linear(8, 8) from the JAX package's seeded init."""
    _, w, b = _jax_weights(seed)
    net = torch.nn.Linear(8, 8)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(w.T.copy()))
        net.bias.copy_(torch.from_numpy(b.copy()))
    m = Model(net)
    cls = topt.Adam if opt == "adam" else topt.Momentum
    m.prepare(cls(0.05, parameters=net.parameters()), torch.nn.MSELoss(),
              scaler=GradScaler(**_scaler()) if scaler else None)
    return m


def _final_state(m):
    sd = {k: v.detach().clone() for k, v in m.network.state_dict().items()}
    sd["@opt_step"] = m._optimizer._step_count
    return sd


class _TripAtStep(PreemptionGuard):
    """Reports a request once the optimizer has taken ``trip_after``
    steps: the in-process stand-in for a SIGTERM landing mid-epoch."""

    def __init__(self, model, trip_after):
        super().__init__()
        self._model = model
        self._trip_after = trip_after

    def requested(self):
        if not super().requested() and \
                self._model._optimizer._step_count >= self._trip_after:
            self.request()
        return super().requested()


def _fit_kw(general, compiled=True):
    kw = dict(batch_size=4, epochs=EPOCHS, verbose=0, compiled=compiled)
    if general:
        # shuffled through two workers: the epoch-seeded order
        kw.update(shuffle=True, num_workers=2)
    else:
        kw.update(shuffle=False)
    return kw


def _jax_uninterrupted(opt, scaler, general):
    net, _, _ = _jax_weights(0)
    m = JModel(net)
    cls = paddle.optimizer.Adam if opt == "adam" else \
        paddle.optimizer.Momentum
    m.prepare(cls(0.05, parameters=net.parameters()), jnn.MSELoss(),
              scaler=paddle.amp.GradScaler(**_scaler()) if scaler else None)
    if general:
        data = ArrayDataset(X, Y)
        m.fit(data, batch_size=4, epochs=EPOCHS, verbose=0, shuffle=True)
    else:
        data = paddle.io.TensorDataset([paddle.to_tensor(X),
                                        paddle.to_tensor(Y)])
        m.fit(data, batch_size=4, epochs=EPOCHS, verbose=0, shuffle=False)
    return {"weight": np.asarray(net.weight.numpy()).T,
            "bias": np.asarray(net.bias.numpy()),
            "@opt_step": m._optimizer._step_count}


CASES = {
    "momentum": dict(opt="momentum"),
    "adam_scaler": dict(opt="adam", scaler=True),
    "eager": dict(opt="momentum", compiled=False),
    "workers": dict(opt="adam", general=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_preempt_resume_parity(tmp_path, name):
    """Trip after step 6 (step 1 of epoch 1), resume from other weights,
    finish: bit for bit the port's uninterrupted run, and the JAX
    package's within rtol 1e-5."""
    case = CASES[name]
    opt, scaler = case["opt"], case.get("scaler", False)
    general = case.get("general", False)
    kw = _fit_kw(general, case.get("compiled", True))
    whole = _model(0, opt, scaler)
    whole.fit(_data(general), **kw)
    ref = _final_state(whole)

    m1 = _model(0, opt, scaler)
    guard = _TripAtStep(m1, 6)
    with pytest.raises(Preempted) as ei:
        m1.fit(_data(general), save_dir=str(tmp_path), preemptible=guard,
               **kw)
    assert ckpt.is_committed(ei.value.checkpoint)
    assert ei.value.epoch == 1
    # epoch-relative: 6 steps at 4 an epoch end on step 1 of epoch 1
    assert ei.value.step == (6 - 1) % STEPS_PER_EPOCH
    assert ckpt.load_values(ei.value.checkpoint)["mid_epoch_step"] == 1
    m2 = _model(123, opt, scaler)
    m2.fit(_data(general), save_dir=str(tmp_path), resume=True, **kw)
    assert [s["epoch"] for s in m2._epoch_summaries] == [1, 2]
    assert m2._epoch_summaries[0]["steps"] == STEPS_PER_EPOCH - 2
    got = _final_state(m2)
    assert got["@opt_step"] == ref["@opt_step"] == EPOCHS * STEPS_PER_EPOCH
    for k in ("weight", "bias"):
        assert torch.equal(got[k], ref[k]), k

    jref = _jax_uninterrupted(opt, scaler, general)
    assert jref["@opt_step"] == got["@opt_step"]
    for k in ("weight", "bias"):
        np.testing.assert_allclose(got[k].numpy(), jref[k], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{name}: {k}")


def test_preempt_scaler_state_restored(tmp_path):
    """The scaler's scale and good-step counter survive the emergency
    checkpoint exactly."""
    m1 = _model(0, "adam", scaler=True)
    guard = _TripAtStep(m1, 5)
    with pytest.raises(Preempted) as ei:
        m1.fit(_data(), batch_size=4, epochs=EPOCHS, verbose=0,
               shuffle=False, save_dir=str(tmp_path), preemptible=guard)
    scale_at_kill = m1._scaler.get_loss_scaling()
    good_at_kill = m1._scaler._good_steps
    assert scale_at_kill > 512.0  # grew at least once (incr_every=3)
    m2 = _model(123, "adam", scaler=True)
    m2.load_checkpoint(ei.value.checkpoint)
    assert m2._scaler.get_loss_scaling() == scale_at_kill
    assert m2._scaler._good_steps == good_at_kill
    assert m2._optimizer._step_count == m1._optimizer._step_count
    assert m2._resume_mid_step == ei.value.step


def test_fit_sigterm_via_fault_injection(tmp_path):
    """A real SIGTERM, sent while fit commits epoch 0's checkpoint (the
    rename of step_0), reaches fit's own guard: the next step boundary
    commits the emergency checkpoint and raises Preempted."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    m = _model(0)
    with FaultInjector() as fi:
        fi.preempt("step_0", op="rename")
        with pytest.raises(Preempted) as ei:
            m.fit(_data(), batch_size=4, epochs=EPOCHS, verbose=0,
                  shuffle=False, save_dir=str(tmp_path))
    assert fi.fires() == 1
    assert ei.value.epoch == 1
    assert ei.value.step == -1      # no step of epoch 1 ran
    assert ckpt.is_committed(ei.value.checkpoint)
    vals = ckpt.load_values(ei.value.checkpoint)
    assert vals["mid_epoch_step"] == ei.value.step
    # the guard fit installed is gone with it
    assert signal.getsignal(signal.SIGTERM) == before


def test_elastic_restart_counters(tmp_path, monkeypatch):
    """A relaunch's PADDLE_RESTART_ROUND and the resume point surface as
    restart/* gauges, the preemption as elastic/* ones."""
    tracer = ttrace.get_tracer()
    was_enabled, tracer.enabled = tracer.enabled, True
    n0 = len(tracer.events)
    try:
        m1 = _model(0)
        guard = _TripAtStep(m1, 6)
        with pytest.raises(Preempted):
            m1.fit(_data(), batch_size=4, epochs=EPOCHS, verbose=0,
                   shuffle=False, save_dir=str(tmp_path),
                   preemptible=guard)
        monkeypatch.setenv("PADDLE_RESTART_ROUND", "2")
        m2 = _model(1)
        m2.fit(_data(), batch_size=4, epochs=EPOCHS, verbose=0,
               shuffle=False, save_dir=str(tmp_path), resume=True)
    finally:
        tracer.enabled = was_enabled
    by_name = {}
    for e in tracer.events[n0:]:
        by_name.setdefault(e.name, []).append(e.args)
    for name in ("elastic/preempt_requested", "elastic/emergency_save_ms",
                 "elastic/emergency_step", "restart/round",
                 "restart/resume_epoch", "restart/resume_step",
                 "hapi/input_wait_ms", "hapi/avg_step_ms"):
        assert name in by_name, (name, sorted(by_name))
    assert by_name["restart/round"][-1]["value"] == 2
    assert by_name["restart/resume_epoch"][-1]["value"] == 1
    assert by_name["restart/resume_step"][-1]["value"] == 2  # mid 1 -> 2
    assert by_name["elastic/emergency_step"][-1]["value"] == 1


def test_preemption_and_resume_reach_the_flight_recorder(tmp_path):
    """The preemption and the resume are events in the flight recorder's
    ring (with the epoch and step each one names)."""
    from paddle_tpu_torch.profiler import flight_recorder as fr
    rec = fr.install(capacity=64)
    try:
        m1 = _model(0)
        with pytest.raises(Preempted):
            m1.fit(_data(), batch_size=4, epochs=EPOCHS, verbose=0,
                   shuffle=False, save_dir=str(tmp_path),
                   preemptible=_TripAtStep(m1, 6))
        _model(1).fit(_data(), batch_size=4, epochs=EPOCHS, verbose=0,
                      shuffle=False, save_dir=str(tmp_path), resume=True)
        events = {e["kind"]: e for e in rec.events()}
    finally:
        fr.uninstall()
    assert events["preempt_requested"]["epoch"] == 1
    assert events["preempt_requested"]["step"] == 1
    assert (events["resume"]["epoch"], events["resume"]["step"]) == (1, 2)


def test_preemptible_true_needs_save_dir():
    m = _model(0)
    with pytest.raises(ValueError, match="save_dir"):
        m.fit(_data(), batch_size=4, epochs=1, verbose=0,
              preemptible=True)


def test_preemptible_false_ignores_a_request(tmp_path):
    """``preemptible=False``: no guard, so a SIGTERM-shaped request is
    never polled; a shared guard instance stays installed after fit."""
    m = _model(0)
    m.fit(_data(), batch_size=4, epochs=1, verbose=0, shuffle=False,
          save_dir=str(tmp_path), preemptible=False)
    assert m._optimizer._step_count == STEPS_PER_EPOCH
    guard = PreemptionGuard()
    try:
        m.fit(_data(), batch_size=4, epochs=1, verbose=0, shuffle=False,
              save_dir=str(tmp_path / "b"), preemptible=guard)
        assert guard._installed
    finally:
        guard.uninstall()


# ---- across layouts --------------------------------------------------------

@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        # a pool killed by a failed call is started again
        if n not in made or not made[n].alive():
            made[n] = RankPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


def _preempt_on_ranks(pools, save_dir, n, hybrid, layout, opt, scaler,
                      trip_after):
    _, w, b = _jax_weights(0)
    got = pools(n).run("torch_ckpt_cases:preempt_fit", hybrid, layout, w, b,
                       X, Y, opt, scaler, str(save_dir), trip_after, {})
    assert all(g == dict(got[0]) for g in got), got
    return got[0]


MESH_CASES = {
    # name: (ranks, degrees, layout), the resume's (ranks, degrees) or
    # None for one process, the optimizer, a GradScaler
    "dp": ((2, {"dp_degree": 2}, None), None, "momentum", False),
    "dp_mp": ((4, {"dp_degree": 2, "mp_degree": 2}, None),
              (2, {"mp_degree": 2}), "momentum", False),
    "adam_slots": ((2, {"mp_degree": 2}, None), None, "adam", True),
    "zero2": ((2, {"sharding_degree": 2, "dp_degree": 1}, "zero2"), None,
              "momentum", False),
}


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_preempt_resume_smaller_layout_matches_jax(pools, tmp_path, name):
    """Trip after step 6 on every rank of the saving layout: the
    emergency checkpoint commits through the barrier; the smaller layout
    resumes and ends at the JAX uninterrupted run's state."""
    from paddle_tpu_torch.profiler import metrics
    (n, hybrid, layout), resume, opt, scaler = MESH_CASES[name]
    pre = _preempt_on_ranks(pools, tmp_path, n, hybrid, layout, opt, scaler,
                            6)
    assert (pre["epoch"], pre["step"], pre["opt_step"]) == (1, 1, 6)
    assert ckpt.validate_checkpoint(pre["checkpoint"])["world_size"] == n
    if resume is None:
        reg = metrics.get_registry()
        reg.gauge("elastic/reshard_tensors").set(0)
        m2 = _model(123, opt, scaler)
        m2.fit(_data(), save_dir=str(tmp_path), resume=True,
               **_fit_kw(False))
        assert [s["epoch"] for s in m2._epoch_summaries] == [1, 2]
        assert reg.gauge("elastic/reshard_tensors").value >= 2
        got = {k: v.numpy() for k, v in _final_state(m2).items()
               if k != "@opt_step"}
        got["@opt_step"] = m2._optimizer._step_count
    else:
        rn, rhybrid = resume
        res = pools(rn).run("torch_ckpt_cases:preempt_fit", rhybrid, None,
                            *_jax_weights(123)[1:], X, Y, opt, scaler,
                            str(tmp_path), None, {"resume": True})
        assert all(r["epochs"] == [1, 2] for r in res)
        got = res[0]
    jref = _jax_uninterrupted(opt, scaler, False)
    assert got["@opt_step"] == jref["@opt_step"] == EPOCHS * STEPS_PER_EPOCH
    for k in ("weight", "bias"):
        np.testing.assert_allclose(got[k], jref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name}: {k}")


def test_preempt_scaler_state_restored_across_layouts(pools, tmp_path):
    """The scaler's scale and good steps, ``@step`` and the mid-epoch
    step are exact after an mp 2 emergency checkpoint is resharded into
    one process."""
    pre = _preempt_on_ranks(pools, tmp_path, 2, {"mp_degree": 2}, None,
                            "adam", True, 5)
    assert pre["scale"] > 512.0  # grew at least once (incr_every=3)
    m2 = _model(123, "adam", scaler=True)
    m2.load_checkpoint(pre["checkpoint"])
    assert m2._scaler.get_loss_scaling() == pre["scale"]
    assert m2._scaler._good_steps == pre["good"]
    assert m2._optimizer._step_count == pre["opt_step"] == 5
    assert m2._resume_mid_step == pre["step"]


def test_ranks_signalled_a_step_apart_stop_at_the_same_step(pools,
                                                           tmp_path):
    """Under dp 2 the guard trips on rank 0 after step 6 and on rank 1
    only after step 7: the flag is all-reduced at every step boundary, so
    both ranks stop after step 6 (a rank that went on would sit in step
    7's gradient all-reduce while the other saved), the emergency
    checkpoint commits through the barrier, and the resumed dp 2 run ends
    bit for bit at the uninterrupted dp 2 run's weights, step count and
    last epoch's mean loss."""
    _, w, b = _jax_weights(0)
    hybrid = {"dp_degree": 2}
    pre = pools(2).run("torch_ckpt_cases:preempt_fit", hybrid, None, w, b,
                       X, Y, "momentum", False, str(tmp_path / "run"),
                       [6, 7], {})
    for res in pre:
        assert (res["epoch"], res["step"], res["opt_step"]) == (1, 1, 6)
        assert res["checkpoint"] == pre[0]["checkpoint"]
    assert ckpt.validate_checkpoint(pre[0]["checkpoint"])["world_size"] == 2
    w2, b2 = _jax_weights(123)[1:]
    resumed = pools(2).run("torch_ckpt_cases:preempt_fit", hybrid, None, w2,
                           b2, X, Y, "momentum", False,
                           str(tmp_path / "run"), None, {"resume": True})
    full = pools(2).run("torch_ckpt_cases:preempt_fit", hybrid, None, w, b,
                        X, Y, "momentum", False, str(tmp_path / "full"),
                        None, {})
    for got, want in zip(resumed, full):
        assert got["epochs"] == [1, 2] and want["epochs"] == [0, 1, 2]
        assert got["@opt_step"] == want["@opt_step"] == \
            EPOCHS * STEPS_PER_EPOCH
        assert got["mean_losses"][-1] == want["mean_losses"][-1]
        for k in ("weight", "bias"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_emergency_save_bounded_by_grace(tmp_path, monkeypatch):
    """The emergency checkpoint's commit barrier gets the guard's
    remaining grace, not 300 s: with a dead peer (a world of 2 in which
    rank 1 never stages) the save fails uncommitted within it."""
    import time as _time

    from paddle_tpu_torch.distributed.checkpoint import save_load
    m = _model(0)
    monkeypatch.setattr(save_load, "_rank_world", lambda group: (0, 2))
    guard = _TripAtStep(m, 2)
    guard.grace_s = 3.0
    t0 = _time.time()
    with pytest.raises(RuntimeError, match="barrier timed out"):
        m.fit(_data(), batch_size=4, epochs=EPOCHS, verbose=0,
              shuffle=False, save_dir=str(tmp_path), preemptible=guard)
    assert _time.time() - t0 < 60.0   # nowhere near the 300 s default
    assert ckpt.latest_valid_checkpoint(str(tmp_path)) is None
