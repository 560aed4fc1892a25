"""The port's ``amp.debugging``, ``profiler`` API and cost model, the
``VisualDL``/``WandbCallback`` callbacks and ``summary`` against the JAX
package's, on the CPU.

- ``check_numerics`` (the same message), ``collect_operator_stats`` (the
  JAX key format ``name[dtype]``, aten's names), ``check_layer_numerics``,
  ``compare_accuracy`` (the same report from the same JSONL dumps) and
  ``enable_check_nan_inf`` (a ``FloatingPointError`` naming the op, where
  the JAX package's ``jax_debug_nans`` names its primitive).
- ``profiler.cost``: every function's FLOPs and bytes equal the JAX
  function's (exact: the same arithmetic); ``device_peaks`` on faked
  device names (the H100 SXM's spec-sheet figures; any other name the
  JAX package's fallback).
- ``make_scheduler`` and ``Profiler(scheduler=)``'s states step by step,
  ``RecordEvent`` in the structured tracer and in a CPU recording.
- ``VisualDL``'s records equal the JAX callback's; ``WandbCallback``
  without ``wandb`` warns once, as the JAX one, and does nothing.
- ``summary``'s dict equals the JAX one for the same tiny Llama.
"""

import dataclasses
import json
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import profiler as jprof
from paddle_tpu.hapi import callbacks as jcallbacks
from paddle_tpu.hapi.summary import summary as jsummary
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.profiler import cost as jcost

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch import summary as tsummary
from paddle_tpu_torch.hapi import callbacks as tcallbacks
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.profiler import cost as tcost
from paddle_tpu_torch.utils import monitor

torch.set_num_threads(1)


# ---- amp.debugging ----------------------------------------------------------

def test_check_numerics_raises_the_jax_message():
    a = np.ones((4, 5), np.float32)
    a[1, 2] = np.nan
    a[3, 0] = np.inf
    with pytest.raises(RuntimeError) as jerr:
        jamp.debugging.check_numerics(paddle.to_tensor(a), "matmul", "out")
    with pytest.raises(RuntimeError) as terr:
        tamp.debugging.check_numerics(torch.from_numpy(a), "matmul", "out")
    assert str(terr.value) == str(jerr.value)
    t = torch.ones(3, dtype=torch.bfloat16)
    assert tamp.debugging.check_numerics(t) is t


def test_collect_operator_stats_counts_aten_ops(capsys):
    x = torch.randn(4, 8)
    w = torch.randn(8, 3, dtype=torch.float64)
    with tamp.debugging.collect_operator_stats():
        torch.mm(x, x.t())
        torch.mm(x, x.t())
        torch.mm(w.t(), w)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "operator stats:"
    stats = dict(line.strip().rsplit(": ", 1) for line in out[1:])
    assert stats["aten.mm.default[float32]"] == "2"
    assert stats["aten.mm.default[float64]"] == "1"
    # the JAX summary's format, over its own op names
    with jamp.debugging.collect_operator_stats():
        paddle.matmul(paddle.to_tensor(x.numpy()),
                      paddle.to_tensor(x.numpy().T))
    jout = capsys.readouterr().out.splitlines()
    assert jout[0] == "operator stats:"
    for line in jout[1:] + out[1:]:
        key, count = line.strip().rsplit(": ", 1)
        assert key.endswith("]") and "[" in key and int(count) > 0
    # collection off: nothing counted
    torch.mm(x, x.t())
    assert monitor.op_stats_summary() == {}


def test_operator_stats_collection_switches():
    tamp.debugging.enable_operator_stats_collection()
    try:
        torch.ones(2) + torch.ones(2)
    finally:
        tamp.debugging.disable_operator_stats_collection()
    assert monitor.op_stats_summary()["aten.add.Tensor[float32]"] == 1


def test_check_layer_numerics_names_the_layer():
    jlin = paddle.nn.Linear(4, 4)
    tlin = Linear(4, 4)
    x = np.full((2, 4), np.inf, np.float32)
    with pytest.raises(RuntimeError) as jerr:
        jamp.debugging.check_layer_numerics(jlin)(paddle.to_tensor(x))
    with pytest.raises(RuntimeError) as terr:
        tamp.debugging.check_layer_numerics(tlin)(torch.from_numpy(x))
    assert str(terr.value) == str(jerr.value)
    assert tlin(torch.ones(2, 4)).shape == (2, 4)


def test_compare_accuracy_writes_the_jax_report(tmp_path):
    rows_a = [{"op": "matmul", "dtype": "bfloat16", "count": 4},
              {"op": "softmax", "dtype": "float32", "count": 2},
              {"op": "gelu", "dtype": "float32", "count": 1}]
    rows_b = [{"op": "matmul", "dtype": "float32", "count": 4},
              {"op": "softmax", "dtype": "float32", "count": 2},
              {"op": "rms_norm", "dtype": "float32", "count": 3}]
    dumps = []
    for name, rows in (("a.jsonl", rows_a), ("b.jsonl", rows_b)):
        path = tmp_path / name
        path.write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
        dumps.append(str(path))
    jrep = jamp.debugging.compare_accuracy(*dumps, str(tmp_path / "j" /
                                                      "report.json"))
    trep = tamp.debugging.compare_accuracy(*dumps, str(tmp_path / "t" /
                                                      "report.json"))
    assert trep == jrep and len(trep) == 3
    assert (tmp_path / "t" / "report.json").read_text() == \
        (tmp_path / "j" / "report.json").read_text()


def test_check_nan_inf_names_the_op():
    import jax
    try:
        jamp.debugging.enable_check_nan_inf()
        with pytest.raises(FloatingPointError) as jerr:
            paddle.log(paddle.to_tensor(np.array([-1.0], np.float32)))
    finally:
        jamp.debugging.disable_check_nan_inf()
    assert not jax.config.jax_debug_nans
    tamp.debugging.enable_check_nan_inf()
    try:
        ok = torch.log(torch.tensor([2.0]))
        with pytest.raises(FloatingPointError) as terr:
            torch.log(torch.tensor([-1.0]))
    finally:
        tamp.debugging.disable_check_nan_inf()
    assert "invalid value (nan) encountered in log" in str(jerr.value)
    assert "invalid value (nan) encountered in aten.log" in str(terr.value)
    assert torch.isfinite(ok).all()
    # an inf is caught too; off again, nothing is checked
    tamp.debugging.enable_check_nan_inf()
    try:
        with pytest.raises(FloatingPointError, match=r"\(inf\).*aten.div"):
            torch.tensor([1.0]) / torch.tensor([0.0])
    finally:
        tamp.debugging.disable_check_nan_inf()
    assert torch.isinf(torch.tensor([1.0]) / torch.tensor([0.0])).all()


def test_debug_mode_enum_is_the_jax_one():
    for name in ("CHECK_NAN_INF_AND_ABORT", "CHECK_NAN_INF",
                 "CHECK_ALL_FOR_OVERFLOW", "CHECK_ALL", "CHECK_ALL_AND_ABORT",
                 "DUMP_ALL"):
        assert getattr(tamp.debugging.DebugMode, name) == \
            getattr(jamp.debugging.DebugMode, name)


# ---- profiler.cost ----------------------------------------------------------

COST_CALLS = [
    ("matmul_cost", (4096, 2560, 6912), {}),
    ("matmul_cost", (7, 11, 13), {"batch": 3, "dtype_bytes": 4}),
    ("grouped_matmul_cost", (40576, 3584, 1408, 60), {}),
    ("attention_cost", (2, 2048, 20, 128), {}),
    ("attention_cost", (2, 5, 8, 64), {"kv_len": 700, "causal": True}),
    ("attention_cost", (16, 512, 12, 64), {"causal": False}),
    ("rms_norm_cost", (4096, 2560), {}),
    ("rms_norm_cost", (4096, 2560), {"residual": True, "train": True}),
    ("swiglu_cost", (4096, 6912), {"train": True}),
    ("fused_linear_ce_cost", (8192, 2048, 32000), {"train": True}),
]


@pytest.mark.parametrize("name,args,kw", COST_CALLS)
def test_cost_functions_count_as_jax(name, args, kw):
    assert getattr(tcost, name)(*args, **kw).to_dict() == \
        getattr(jcost, name)(*args, **kw).to_dict()


def test_step_flops_moe_sections_mfu_and_roofline_as_jax():
    args = (2.366e9, 4096, 32, 2, 2048, 2560)
    assert tcost.transformer_step_flops(*args) == \
        jcost.transformer_step_flops(*args)
    for kw in ({}, {"dropless": False, "capacity_factor": 2.0},
               {"train": False, "num_moe_layers": 12}):
        t = tcost.moe_section_costs(8192, 1024, 1408, 16, 2, **kw)
        j = jcost.moe_section_costs(8192, 1024, 1408, 16, 2, **kw)
        assert {k: v.to_dict() for k, v in t.items()} == \
            {k: v.to_dict() for k, v in j.items()}
    peaks = (tcost.Peaks(989.4e12, 3.35e12, "h100-sxm"),
             jcost.Peaks(989.4e12, 3.35e12, "h100-sxm"))
    for flops, nbytes in ((1e12, 1e9), (1e9, 1e9), (5.0, 0)):
        assert tcost.roofline(flops, nbytes, peaks[0]) == \
            jcost.roofline(flops, nbytes, peaks[1])
    assert tcost.mfu(6.6e13, 0.35, peak=989.4e12) == \
        jcost.mfu(6.6e13, 0.35, peak=989.4e12)
    s = tcost.SectionCost(3.0, 4.0)
    assert (2 * (s + s)).to_dict() == {"flops": 12.0, "bytes": 16.0}


@pytest.mark.parametrize("kind,flops,bw", [
    ("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12),
    ("NVIDIA H100 SXM5 80GB", 989.4e12, 3.35e12),
    ("NVIDIA A100-SXM4-80GB", None, None),
    ("NVIDIA H100 PCIe", None, None),
    ("cpu", None, None)])
def test_device_peaks_on_faked_names(kind, flops, bw):
    dev = types.SimpleNamespace(device_kind=kind)
    p = tcost.device_peaks(dev)
    if flops is None:
        fallback = jcost.device_peaks(types.SimpleNamespace(
            device_kind="no such device"))
        assert (p.flops, p.hbm_bw, p.kind) == \
            (fallback.flops, fallback.hbm_bw, fallback.kind)
    else:
        assert (p.flops, p.hbm_bw, p.kind) == (flops, bw, "h100-sxm")
        assert tcost.peak_flops(dev) == flops
    # the CPU, or no card: the fallback
    assert tcost.device_peaks(torch.device("cpu")).kind == "unknown"


# ---- the profiler API -------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"closed": 1, "ready": 1, "record": 2},
    {"closed": 2, "record": 3, "repeat": 2, "skip_first": 1},
    {"ready": 1, "record": 1, "repeat": 1}])
def test_make_scheduler_states_as_jax(kw):
    t, j = tprof.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [t(s) for s in range(16)] == [j(s) for s in range(16)]


def test_profiler_scheduler_window_and_record_event(tmp_path):
    """A (lo, hi) window's states are the JAX Profiler's; the CPU target
    records steps lo..hi-1 into one chrome trace holding the
    RecordEvent range; with with_flops the structured tracer records the
    span and restores its prior state on stop."""
    jp = jprof.Profiler(scheduler=(1, 3))
    tp = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU], scheduler=(1, 3),
                        on_trace_ready=tprof.export_chrome_tracing(
                            str(tmp_path)), with_flops=True)
    assert [tp._scheduler(s) for s in range(5)] == \
        [jp._scheduler(s) for s in range(5)]
    tr = tprof.get_tracer()
    tr.clear()
    assert not tr.enabled
    with tp:
        states = []
        for step in range(4):
            states.append(tp._scheduler(tp._step))
            with tprof.RecordEvent(f"user_range_{step}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            tp.step()
    assert states == [tprof.ProfilerState.CLOSED, tprof.ProfilerState.RECORD,
                      tprof.ProfilerState.RECORD, tprof.ProfilerState.CLOSED]
    assert not tr.enabled
    assert [e.name for e in tr.events if e.cat == "record_event"] == \
        [f"user_range_{s}" for s in range(4)]
    assert len(tp.trace_paths) == 1
    names = {e["name"] for e in json.load(open(tp.trace_paths[0]))[
        "traceEvents"]}
    assert {"user_range_1", "user_range_2"} <= names
    assert not {"user_range_0", "user_range_3"} & names
    tr.clear()


def test_flags_and_env_drive_the_tracer(monkeypatch, tmp_path):
    opts = tprof.ProfilerOptions.from_env()
    assert opts == tprof.ProfilerOptions()
    monkeypatch.setenv("PADDLE_PROFILER_LOG_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_PROFILER_WITH_FLOPS", "1")
    assert dataclasses.asdict(tprof.ProfilerOptions.from_env()) == \
        dataclasses.asdict(jprof.ProfilerOptions.from_env())
    tr = tprof.enable()
    try:
        with tprof.trace_span("step", flops=1e9):
            pass
    finally:
        path = tprof.disable()
    assert path == str(tmp_path / "paddle_trace.json")
    assert json.load(open(path))["traceEvents"][0]["name"] == "step"
    tr.clear()


# ---- callbacks and summary --------------------------------------------------

def _drive(cb):
    for step, loss in enumerate((2.5, 2.25, "n/a", 2.0)):
        cb.on_train_batch_end(step, {"loss": loss, "lr": 1e-3})
    cb.on_eval_end({"loss": 1.75, "acc": 0.5})
    cb.on_train_batch_end(4, {"loss": np.float32(1.5)})
    cb._writer.close()


def test_visualdl_writes_the_jax_records(tmp_path):
    _drive(jcallbacks.VisualDL(str(tmp_path / "jax")))
    _drive(tcallbacks.VisualDL(str(tmp_path / "port")))
    port = (tmp_path / "port" / "metrics.jsonl").read_text()
    assert port == (tmp_path / "jax" / "metrics.jsonl").read_text()
    recs = [json.loads(x) for x in port.splitlines()]
    assert recs[0] == {"tag": "train/loss", "value": 2.5, "step": 1}
    assert {"tag": "eval/acc", "value": 0.5, "step": 4} in recs


def test_wandb_callback_without_wandb_is_a_no_op(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.warns(UserWarning) as jw:
        jcb = jcallbacks.WandbCallback(project="p")
    with pytest.warns(UserWarning) as tw:
        tcb = tcallbacks.WandbCallback(project="p")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == 1 and "WandbCallback is a no-op" in str(tw[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tcb.on_train_batch_end(0, {"loss": 1.0})
        tcb.on_eval_end({"loss": 1.0})
        tcb.on_train_end()
    assert tcb._wandb is None and jcb._wandb is None


def test_summary_returns_the_jax_dict(capsys):
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.lm_head.weight.requires_grad_(False)
    jm.lm_head.weight.trainable = False
    ref = jsummary(jm)
    jout = capsys.readouterr().out
    got = tsummary(tm)
    tout = capsys.readouterr().out
    assert got == ref
    assert got["trainable_params"] < got["total_params"]
    # the same totals lines and one table row a parameter
    assert tout.splitlines()[-2:] == jout.splitlines()[-2:]
    assert len(tout.splitlines()) == len(jout.splitlines())
