"""The port's ``hapi.Model`` beyond ``fit``'s step, its callbacks, metrics
and step-metrics records, against the JAX package on the CPU.

evaluate/predict/eval_batch take the tiny Llama from the same weights on
both sides (f32: losses within 1e-5 relative, logits within 1e-4 /
1e-5, as tests/test_torch_training.py holds the forward). The six cases
of tests/test_hapi_resume.py run on the port, with a resumed ``fit``
equal bit for bit to an uninterrupted one. The metrics see the same
numpy inputs and must give the JAX package's numbers (to 1e-7).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCriterion

from paddle_tpu_torch import convert
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.hapi import Model, callbacks
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.utils import monitor

torch.set_num_threads(1)


# ---- the tiny Llama against the JAX package -------------------------------

@pytest.fixture
def unfused():
    name = "FLAGS_fused_rmsnorm_residual"
    saved = [(reg, dict(reg._registry[name])) for reg in (flags, tflags)]
    for reg, _ in saved:
        reg.set_flags({name: False})
    yield
    for reg, ent in saved:
        reg._registry[name] = ent


def _llamas():
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(),
                                             scan_layers=False),
                         device="cpu"), arrays)
    jmodel = paddle.Model(jm)
    jmodel.prepare(None, JCriterion(jm.config))
    tmodel = Model(tm)
    tmodel.prepare(topt.SGD(0.1, parameters=tm.parameters()),
                   LlamaPretrainingCriterion(tm.config))
    return jmodel, tmodel


IDS = np.random.RandomState(4).randint(0, 256, (6, 17))


def test_eval_batch_evaluate_and_predict_match_jax(unfused):
    jmodel, tmodel = _llamas()
    jl = jmodel.eval_batch([paddle.to_tensor(IDS[:2])],
                           paddle.to_tensor(IDS[:2]))[0]
    tl = tmodel.eval_batch([torch.from_numpy(IDS[:2])],
                           torch.from_numpy(IDS[:2]))[0]
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    jds = paddle.io.TensorDataset([paddle.to_tensor(IDS)] * 2)
    tds = TensorDataset([torch.from_numpy(IDS)] * 2)
    jev = jmodel.evaluate(jds, batch_size=2, verbose=0, compiled=False)
    for compiled in (False, True):
        tev = tmodel.evaluate(tds, batch_size=2, verbose=0,
                              compiled=compiled)
        assert abs(tev["loss"][0] - jev["loss"][0]) <= \
            1e-5 * abs(jev["loss"][0])
    jpred = jmodel.predict(paddle.io.TensorDataset([paddle.to_tensor(IDS)]),
                           batch_size=4)
    tpred = tmodel.predict(TensorDataset([torch.from_numpy(IDS)]),
                           batch_size=4)
    assert len(tpred) == len(jpred) == 2
    for t, j in zip(tpred, jpred):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()),
                                   rtol=1e-4, atol=1e-5)
    assert not tmodel.network.training


def test_evaluate_inside_fit_takes_the_fused_loss(unfused):
    """fit's compiled evaluate takes the network's fused linear+CE loss
    (the flag is on inside fit); it equals the unfused evaluate."""
    _, tmodel = _llamas()
    tds = TensorDataset([torch.from_numpy(IDS)] * 2)
    plain = tmodel.evaluate(tds, batch_size=3, verbose=0)["loss"][0]
    with tflags.scoped_default("FLAGS_fused_linear_cross_entropy", True):
        assert tmodel._fused_network_loss()
        fused = tmodel.evaluate(tds, batch_size=3, verbose=0)["loss"][0]
    assert abs(fused - plain) <= 1e-5 * plain


def test_save_and_load_round_trip(tmp_path, unfused):
    _, tmodel = _llamas()
    t = torch.from_numpy(IDS[:2])
    tmodel.train_batch([t], t)
    tmodel.save(str(tmp_path / "m"))
    assert (tmp_path / "m.pdparams").exists() and \
        (tmp_path / "m.pdopt").exists()
    _, other = _llamas()
    other.load(str(tmp_path / "m"))
    assert torch.equal(other.predict_batch([t]), tmodel.predict_batch([t]))
    assert other._optimizer._step_count == 1
    l1 = tmodel.train_batch([t], t)[0]
    l2 = other.train_batch([t], t)[0]
    assert l1 == l2
    tmodel.save(str(tmp_path / "w"), training=False)
    assert not (tmp_path / "w.pdopt").exists()


def test_summary_and_parameters():
    _, tmodel = _llamas()
    n = sum(p.numel() for p in tmodel.network.parameters())
    assert tmodel.summary() == {"total_params": n}
    assert sum(p.numel() for p in tmodel.parameters()) == n


# ---- tests/test_hapi_resume.py on the port ----------------------------------

def _data():
    x = np.random.RandomState(0).randn(8, 4).astype("float32")
    y = np.random.RandomState(1).randn(8, 1).astype("float32")
    return TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])


def _model(seed):
    net = torch.nn.Linear(4, 1)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        net.weight.copy_(torch.randn(1, 4, generator=g))
        net.bias.copy_(torch.randn(1, generator=g))
    m = Model(net)
    m.prepare(topt.Adam(0.05, parameters=net.parameters()),
              torch.nn.MSELoss())
    return m


def test_fit_writes_committed_step_checkpoints(tmp_path):
    m = _model(0)
    m.fit(_data(), batch_size=4, epochs=2, verbose=0, save_dir=str(tmp_path))
    for e in (0, 1):
        assert ckpt.is_committed(str(tmp_path / f"step_{e}"))
        assert os.path.exists(tmp_path / f"epoch_{e}.pdparams")
    best = ckpt.latest_valid_checkpoint(str(tmp_path))
    assert os.path.basename(best) == "step_1"
    assert ckpt.load_values(best)["epoch"] == 1


def test_fit_resume_restores_state_and_skips_done_epochs(tmp_path):
    m1 = _model(0)
    m1.fit(_data(), batch_size=4, epochs=2, verbose=0,
           save_dir=str(tmp_path))
    w1 = m1.network.weight.detach().clone()
    step1 = m1._optimizer._step_count
    ckpt.save_state_dict({"model": m1.network.state_dict()},
                         str(tmp_path / "step_2"))
    os.remove(tmp_path / "step_2" / "COMMITTED")
    m2 = _model(123)
    assert not torch.allclose(m2.network.weight, w1)
    m2.fit(_data(), batch_size=4, epochs=2, verbose=0,
           save_dir=str(tmp_path), resume=True)
    assert torch.equal(m2.network.weight, w1)
    assert m2._optimizer._step_count == step1


def test_fit_resume_continues_training(tmp_path):
    m1 = _model(0)
    m1.fit(_data(), batch_size=4, epochs=1, verbose=0,
           save_dir=str(tmp_path))
    m2 = _model(123)
    m2.fit(_data(), batch_size=4, epochs=3, verbose=0,
           save_dir=str(tmp_path), resume=True, keep_last_n=2)
    assert ckpt.is_committed(str(tmp_path / "step_2"))
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_1", "step_2"]
    # and it is the run an uninterrupted fit makes, shuffle included
    whole = _model(0)
    whole.fit(_data(), batch_size=4, epochs=3, verbose=0)
    assert torch.equal(m2.network.weight, whole.network.weight)
    assert torch.equal(m2.network.bias, whole.network.bias)


def test_fit_resume_explicit_path_and_env(tmp_path, monkeypatch):
    m1 = _model(0)
    m1.fit(_data(), batch_size=4, epochs=1, verbose=0,
           save_dir=str(tmp_path / "a"))
    w1 = m1.network.weight.detach().clone()
    m2 = _model(7)
    m2.fit(_data(), batch_size=4, epochs=1, verbose=0,
           resume=str(tmp_path / "a" / "step_0"))
    assert torch.equal(m2.network.weight, w1)
    monkeypatch.setenv("PADDLE_RESUME_CHECKPOINT",
                       str(tmp_path / "a" / "step_0"))
    m3 = _model(8)
    m3.fit(_data(), batch_size=4, epochs=1, verbose=0, resume=True)
    assert torch.equal(m3.network.weight, w1)


def test_fit_resume_corrupt_checkpoint_raises(tmp_path):
    m1 = _model(0)
    m1.fit(_data(), batch_size=4, epochs=1, verbose=0,
           save_dir=str(tmp_path))
    shard = next(p for p in (tmp_path / "step_0").iterdir()
                 if p.name.endswith(".npy") and "weight" in p.name)
    blob = bytearray(shard.read_bytes())
    blob[-1] ^= 0xFF
    shard.write_bytes(bytes(blob))
    m2 = _model(1)
    with pytest.raises(ckpt.CheckpointCorruptError):
        m2.fit(_data(), batch_size=4, epochs=1, verbose=0,
               resume=str(tmp_path / "step_0"))


def test_model_checkpoint_callback_atomic(tmp_path):
    m = _model(0)
    cb = callbacks.ModelCheckpoint(save_dir=str(tmp_path), keep_last_n=2)
    cb.set_model(m)
    for epoch in range(4):
        cb.on_epoch_end(epoch)
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_2", "step_3"]
    assert all(ckpt.is_committed(str(tmp_path / s)) for s in steps)
    legacy = callbacks.ModelCheckpoint(save_dir=str(tmp_path / "legacy"),
                                       atomic=False)
    legacy.set_model(m)
    os.makedirs(tmp_path / "legacy")
    legacy.on_epoch_end(0)
    assert os.path.exists(tmp_path / "legacy" / "0.pdparams")


def test_checkpoint_carries_the_scheduler_scaler_and_mid_epoch_step(
        tmp_path):
    from paddle_tpu_torch.amp import GradScaler
    net = torch.nn.Linear(4, 1)
    sched = topt.lr.StepDecay(0.1, 2)
    m = Model(net)
    m.prepare(topt.Momentum(sched, parameters=net.parameters()),
              torch.nn.MSELoss(), scaler=GradScaler(init_loss_scaling=64.0))
    m.fit(_data(), batch_size=4, epochs=1, verbose=0, shuffle=False)
    for _ in range(3):
        sched.step()
    m.save_checkpoint(str(tmp_path / "ck"), epoch=4, mid_epoch_step=1)
    net2 = torch.nn.Linear(4, 1)
    sched2 = topt.lr.StepDecay(0.1, 2)
    m2 = Model(net2)
    m2.prepare(topt.Momentum(sched2, parameters=net2.parameters()),
               torch.nn.MSELoss(), scaler=GradScaler())
    assert m2.load_checkpoint(str(tmp_path / "ck")) == 4
    assert m2._resume_mid_step == 1
    assert sched2.state_dict() == sched.state_dict()
    assert m2._scaler.state_dict() == m._scaler.state_dict()
    assert m2._optimizer._step_count == 2
    assert torch.equal(net2.weight, net.weight)
    m.fit(_data(), batch_size=4, epochs=5, verbose=0, shuffle=False,
          resume=str(tmp_path / "ck"))
    # the mid-epoch checkpoint redoes epoch 4 from step 2: no step left
    assert m._last_epoch_summary["steps"] == 0


# ---- the fit loop's records and data ----------------------------------------

@pytest.mark.parametrize("compiled", [True, False])
def test_fit_emits_a_record_per_loss(compiled):
    seen = []
    remove = monitor.register_step_metrics_hook(seen.append)
    try:
        m = _model(0)
        m.fit(_data(), batch_size=4, epochs=1, verbose=0, compiled=compiled)
    finally:
        remove()
    assert len(seen) == 2                 # 8 samples / batch 4
    assert all("loss" in s and "epoch" in s for s in seen)


def test_scalar_writer_takes_the_records(tmp_path):
    import json
    seen = []
    remove = monitor.register_step_metrics_hook(seen.append)
    with monitor.ScalarWriter(str(tmp_path)) as w:
        rm2 = monitor.register_step_metrics_hook(w)
        monitor.emit_step_metrics(loss=1.5, lr=0.1)
        monitor.emit_step_metrics(loss=torch.tensor(1.25), lr=0.1)
        rm2()
    remove()
    assert len(seen) == 2 and seen[0]["loss"] == 1.5 and "step" in seen[0]
    lines = [json.loads(line) for line in open(w.path)]
    assert len(lines) == 2 and lines[1]["loss"] == 1.25
    monitor.emit_step_metrics(loss=9.9)
    assert len(seen) == 2


def test_fit_with_eval_data_and_a_loader():
    m = _model(0)
    loader = DataLoader(_data(), batch_size=4)
    m.fit(loader, eval_data=_data(), batch_size=4, epochs=2, eval_freq=1,
          verbose=0)
    assert [s["steps"] for s in m._epoch_summaries] == [2, 2]
    assert np.isfinite(m.evaluate(_data(), batch_size=8,
                                  verbose=0)["loss"][0])


# ---- callbacks driven by hand -----------------------------------------------

def test_callbacks_driven_by_hand(capsys):
    net = torch.nn.Linear(4, 1)
    sched = topt.lr.ExponentialDecay(0.1, 0.5)
    m = Model(net)
    m.prepare(topt.SGD(sched, parameters=net.parameters()),
              torch.nn.MSELoss())
    lr_cb = callbacks.LRScheduler(by_step=True, by_epoch=True)
    lr_cb.set_model(m)
    lr_cb.on_train_batch_end(0)
    lr_cb.on_epoch_end(0)
    assert m._optimizer.get_lr() == 0.1 * 0.5 ** 2
    stop = callbacks.EarlyStopping(monitor="loss", patience=1)
    for v in (1.0, 0.5, 0.6, 0.7):
        stop.on_eval_end({"loss": [v]})
    assert stop.stopped and stop.best == 0.5
    m2 = Model(net)
    m2.prepare(topt.SGD(0.2, parameters=net.parameters()),
               torch.nn.MSELoss())
    plateau = callbacks.ReduceLROnPlateau(patience=0, factor=0.5)
    plateau.set_model(m2)
    for v in (1.0, 1.0, 1.0):
        plateau.on_eval_end({"loss": v})
    assert m2._optimizer.get_lr() == 0.05
    log = callbacks.ProgBarLogger(log_freq=2)
    log.on_train_batch_end(2, {"loss": 0.5})
    log.on_train_batch_end(3, {"loss": 0.4})
    assert capsys.readouterr().out == "step 2: {'loss': 0.5}\n"
    base = callbacks.Callback()
    base.set_params({"epochs": 1})
    assert base.params == {"epochs": 1}


def test_fit_accepts_callbacks_and_does_not_run_them():
    """As in the JAX package (a reference trait): fit takes callbacks and
    never calls them."""
    class Counter(callbacks.Callback):
        calls = 0

        def on_epoch_end(self, epoch, logs=None):
            Counter.calls += 1
    m = _model(0)
    m.fit(_data(), batch_size=4, epochs=2, verbose=0,
          callbacks=[Counter()])
    assert Counter.calls == 0


# ---- metrics against the JAX package ----------------------------------------

def _scores(seed, n=40, c=6):
    rng = np.random.RandomState(seed)
    return rng.rand(n, c).astype(np.float32), rng.randint(0, c, (n, 1))


def test_accuracy_matches_jax():
    pred, label = _scores(0)
    pred[3, :] = 0.5                       # a tie: ordered by index
    for k in (1, 3):
        j = paddle.metric.accuracy(paddle.to_tensor(pred),
                                   paddle.to_tensor(label), k=k)
        t = tmetric.accuracy(torch.from_numpy(pred),
                             torch.from_numpy(label), k=k)
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()),
                                   rtol=1e-7)


def test_streaming_accuracy_matches_jax():
    jm = paddle.metric.Accuracy(topk=(1, 3))
    tm = tmetric.Accuracy(topk=(1, 3))
    for seed in range(3):
        pred, label = _scores(seed)
        jc = jm.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc.numpy()))
        assert tm.update(tc) == jm.update(jc)
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name() == ["acc_top1", "acc_top3"]
    tm.reset()
    assert tm.accumulate() == [0.0, 0.0]


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(name):
    jm = getattr(paddle.metric, name)()
    tm = getattr(tmetric, name)()
    rng = np.random.RandomState(5)
    for _ in range(3):
        preds = rng.rand(32).astype(np.float32)
        labels = (rng.rand(32) < preds).astype(np.int64)
        if name == "Auc":
            preds = np.stack([1 - preds, preds], axis=1)
        jm.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert tm.accumulate() == pytest.approx(jm.accumulate(), rel=1e-7)
    assert 0.0 < tm.accumulate() <= 1.0
    assert tm.name() == jm.name()


def test_prepare_keeps_the_metrics():
    m = Model(torch.nn.Linear(2, 1))
    acc = tmetric.Accuracy()
    m.prepare(metrics=acc)
    assert m._metrics == [acc]


def test_to_moves_nested_collate_outputs():
    """fit/evaluate/predict move a batch's tensors to the network's
    device inside dicts, lists and tuples too (a collate's output)."""
    from paddle_tpu_torch.hapi.model import _to
    t = torch.ones(2)
    moved = _to({"x": t, "pair": (t, [t, "name"]), "n": 3}, "cpu")
    assert isinstance(moved, list) and len(moved) == 1
    got = moved[0]
    assert set(got) == {"x", "pair", "n"} and got["n"] == 3
    assert isinstance(got["pair"], tuple) and got["pair"][1][1] == "name"
    assert torch.equal(got["pair"][1][0], t)
    assert [x.shape for x in _to([t, t], "cpu")] == [(2,), (2,)]

