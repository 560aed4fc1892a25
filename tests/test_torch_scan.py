"""``scan_layers`` in the port (``paddle_tpu_torch.nn.scan`` and the
models' scanned branches) against the JAX package's, on the CPU, and the
configs' repair: every JAX preset builds in the port with the same
fields.

- ``can_scan``: the same decisions and decline reasons (each logged once
  on the perf logger).
- ``scan_layers``: the ``full_save_interval`` groups (the first fs - 1
  layers of a group recomputed, the last saved whole), fs 1 as no
  recompute, and the JAX warning when fs does not tile the depth.
- Llama and Qwen2 with ``scan_layers`` on and off (with and without
  recompute and the fs groups), GPT-2 and ERNIE through ``scan_layers``:
  loss and every gradient against the JAX models within 1e-5 (loss,
  relative) and rtol 1e-4 / atol 1e-6 (gradients), f32, tiny sizes; the
  granularity warning of the scanned Llama.
"""

import dataclasses
import importlib
import logging
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models import deepseek as jdeepseek
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import gpt2 as jgpt2
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import qwen2 as jqwen2
from paddle_tpu.nn import scan as jscan
from paddle_tpu.profiler import trace as jtrace

from paddle_tpu_torch import convert
from paddle_tpu_torch.models import deepseek as tdeepseek
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import gpt2 as tgpt2
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import qwen2 as tqwen2
from paddle_tpu_torch.nn import scan as tscan
from paddle_tpu_torch.profiler import trace as ttrace

torch.set_num_threads(1)


# ---- the configs ------------------------------------------------------------

PRESETS = [(jllama.LlamaConfig, tllama.LlamaConfig, p)
           for p in ("tiny", "llama_1b", "llama_2_4b", "llama3_8b",
                     "llama3_70b")]
PRESETS += [(jqwen2.Qwen2Config, tqwen2.Qwen2Config, p)
            for p in ("tiny", "qwen2_7b")]
PRESETS += [(jqwen2.Qwen2MoeConfig, tqwen2.Qwen2MoeConfig, p)
            for p in ("tiny", "qwen2_7b", "qwen2_moe_a14b")]
PRESETS += [(jgpt2.GPT2Config, tgpt2.GPT2Config, p) for p in ("tiny", "small")]
PRESETS += [(jernie.ErnieConfig, ternie.ErnieConfig, p)
            for p in ("tiny", "base")]
PRESETS += [(jdeepseek.DeepseekV2Config, tdeepseek.DeepseekV2Config, "tiny"),
            (jdeepseek.DeepseekV2Config, tdeepseek.DeepseekV2Config, None)]


@pytest.mark.parametrize("jcls,tcls,preset", PRESETS,
                         ids=[f"{j.__name__}.{p}" for j, _, p in PRESETS])
def test_every_preset_has_the_jax_fields(jcls, tcls, preset):
    ref = jcls() if preset is None else getattr(jcls, preset)()
    port = tcls() if preset is None else getattr(tcls, preset)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_the_jax_bench_constructions_build():
    assert tllama.LlamaConfig(scan_layers=False).scan_layers is False
    cfg = dataclasses.replace(tqwen2.Qwen2MoeConfig.tiny(), scan_layers=False)
    assert cfg.scan_layers is False and cfg.num_experts == 8
    # the parallel fields at their no-op values (Llama's TP layers are
    # the plain ones without a mesh, in both packages)
    tllama.LlamaConfig(tensor_parallel=False)


@pytest.mark.parametrize("cls,field,value", [
    (tllama.LlamaConfig, "sep_parallel", "ring"),
    (tllama.LlamaConfig, "sequence_parallel", True),
    (tqwen2.Qwen2Config, "tensor_parallel", True),
    (tqwen2.Qwen2MoeConfig, "sep_parallel", "ulysses")])
def test_parallel_fields_raise_naming_a7(cls, field, value):
    """Context, tensor and sequence parallelism are ported (only an
    unknown ``sep_parallel`` name raises, ``ValueError`` as the JAX
    ``sep_attention``'s), and without a fleet the model they build is the
    plain one, bit for bit."""
    model_cls = {tllama.LlamaConfig: tllama.LlamaForCausalLM,
                 tqwen2.Qwen2Config: tqwen2.Qwen2ForCausalLM,
                 tqwen2.Qwen2MoeConfig: tqwen2.Qwen2MoeForCausalLM}[cls]
    cfg = cls.tiny()
    setattr(cfg, field, value)
    if field == "sep_parallel":
        with pytest.raises(ValueError, match="unknown sep impl"):
            cls(**{field: "ringg"})
        # set after construction, the model refuses it
        bad = cls.tiny()
        bad.sep_parallel = "ringg"
        with pytest.raises(ValueError, match="unknown sep impl"):
            model_cls(bad, device="cpu")
    cls(**{field: value})
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 9)))
    got = model_cls(cfg, device="cpu")(ids)
    want = model_cls(cls.tiny(), device="cpu")(ids)
    assert torch.equal(got, want)


# ---- can_scan ---------------------------------------------------------------

class _JBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc = jnn.Linear(d, d)

    def forward(self, x):
        return self.fc(x)


class _TBlock(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc = torch.nn.Linear(d, d)

    def forward(self, x):
        return self.fc(x)


class _JOther(_JBlock):
    pass


class _TOther(_TBlock):
    pass


class _JEmpty(jnn.Layer):
    def forward(self, x):
        return x


class _TEmpty(torch.nn.Module):
    def forward(self, x):
        return x


_JBlock.__name__ = _TBlock.__name__ = "Block"
_JOther.__name__ = _TOther.__name__ = "Other"
_JEmpty.__name__ = _TEmpty.__name__ = "Empty"

STACKS = {"one": lambda B, O, E: [B(4)],
          "same": lambda B, O, E: [B(4), B(4), B(4)],
          "shapes": lambda B, O, E: [B(4), B(4), B(8)],
          "class": lambda B, O, E: [B(4), O(4)],
          "empty": lambda B, O, E: [E(), E()]}


@pytest.fixture
def fresh_perf_log():
    jtrace._logged_once.clear()
    ttrace._logged_once.clear()
    yield
    jtrace._logged_once.clear()
    ttrace._logged_once.clear()


def _reasons(caplog, logger):
    out = []
    for r in caplog.records:
        if r.name == logger and "scan/declined" in r.getMessage():
            msg = r.getMessage()
            out.append(msg[msg.index("declined (") + 10:msg.index("); ")])
    return out


@pytest.mark.parametrize("stack", list(STACKS))
def test_can_scan_decides_and_declines_as_jax(stack, caplog, fresh_perf_log):
    caplog.set_level(logging.INFO)
    jlayers = STACKS[stack](_JBlock, _JOther, _JEmpty)
    tlayers = STACKS[stack](_TBlock, _TOther, _TEmpty)
    for _ in range(2):      # the second decline of a reason is not logged
        assert tscan.can_scan(tlayers) == jscan.can_scan(jlayers)
    jr = _reasons(caplog, "paddle_tpu.perf")
    tr = _reasons(caplog, "paddle_tpu_torch.perf")
    assert tr == jr
    assert len(tr) == (0 if stack == "same" else 1)


# ---- scan_layers' structure -------------------------------------------------

class _Counting(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4,), 1.1))
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        return torch.sin(x * self.w)


@pytest.mark.parametrize("remat,fs,calls", [
    (False, 0, [1, 1, 1, 1]), (True, 0, [2, 2, 2, 2]),
    (True, 2, [2, 1, 2, 1]), (True, 4, [2, 2, 2, 1]),
    (True, 1, [1, 1, 1, 1]), (True, None, [2, 2, 2, 2]),
    (False, 2, [1, 1, 1, 1])])
def test_full_save_interval_groups(remat, fs, calls):
    """A recomputed layer runs again in the backward; the last layer of
    each group of fs runs once. The result never changes."""
    layers = [_Counting() for _ in range(4)]
    x = torch.linspace(-1, 1, 4, requires_grad=True)
    y = tscan.scan_layers(layers, x, remat=remat, full_save_interval=fs)
    y.sum().backward()
    assert [m.calls for m in layers] == calls
    ref = x.detach()
    for m in layers:
        ref = torch.sin(ref * m.w.detach())
    assert torch.equal(y.detach(), ref)


def test_untiled_interval_warns_as_jax_and_drops_the_dose():
    jlayers = [_JBlock(4) for _ in range(4)]
    with pytest.warns(UserWarning) as jw:
        jscan.scan_layers(jlayers, paddle.to_tensor(
            np.ones((2, 4), np.float32)), remat=True, full_save_interval=3)
    layers = [_Counting() for _ in range(4)]
    x = torch.ones(4, requires_grad=True)
    with pytest.warns(UserWarning) as tw:
        y = tscan.scan_layers(layers, x, remat=True, full_save_interval=3)
    y.sum().backward()
    assert [m.calls for m in layers] == [2, 2, 2, 2]
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


# ---- the models -------------------------------------------------------------

def _grads_match(tm, tloss, tg, jloss, jg):
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg) and len(tg) == len(list(tm.parameters()))
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def _jax_step(jm, ids):
    t = paddle.to_tensor(ids)
    _, loss = jm(t, labels=t)
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
             if p.grad is not None}
    return float(loss.numpy()), grads


def _port_step(tm, ids):
    t = torch.from_numpy(ids)
    _, loss = tm(t, labels=t)
    loss.backward()
    grads = convert.grads_to_numpy(tm)
    tm.zero_grad(set_to_none=True)
    return loss.item(), grads


def _pair(jmod, tmod, cfg_name, model_name, **fields):
    jcfg = dataclasses.replace(getattr(jmod, cfg_name).tiny(), **fields)
    if hasattr(jcfg, "tensor_parallel") and cfg_name == "LlamaConfig":
        jcfg.tensor_parallel = False
    paddle.seed(0)
    jm = getattr(jmod, model_name)(jcfg)
    jm.train()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = dataclasses.replace(getattr(tmod, cfg_name).tiny(), **fields)
    tm = convert.from_numpy_state_dict(
        getattr(tmod, model_name)(tcfg, device="cpu"), arrays)
    tm.train()
    return jm, tm


def _count_scans(monkeypatch, *modules):
    calls = []
    for mod in modules:
        real = mod.scan_layers

        def counting(*a, _real=real, **k):
            calls.append(1)
            return _real(*a, **k)
        monkeypatch.setattr(mod, "scan_layers", counting)
    return calls


@pytest.mark.parametrize("scan,remat,fs", [
    (True, False, 0), (True, True, 0), (True, True, 2), (True, True, 1),
    (False, False, 0), (False, True, 2)])
def test_llama_scanned_and_unrolled_match_jax(scan, remat, fs, monkeypatch):
    jm, tm = _pair(jllama, tllama, "LlamaConfig", "LlamaForCausalLM",
                   scan_layers=scan, use_recompute=remat,
                   full_save_interval=fs)
    jscans = _count_scans(monkeypatch, importlib.import_module(
        "paddle_tpu.nn.scan"))
    tscans = _count_scans(monkeypatch, tllama)
    ids = np.random.RandomState(1).randint(0, 256, (2, 33))
    _grads_match(tm, *_port_step(tm, ids), *_jax_step(jm, ids))
    assert len(tscans) == len(jscans) == int(scan)


def test_scanned_llama_warns_of_granularity_as_jax():
    kw = dict(scan_layers=True, use_recompute=True,
              recompute_granularity="core_attn")
    jm, tm = _pair(jllama, tllama, "LlamaConfig", "LlamaForCausalLM", **kw)
    ids = np.random.RandomState(2).randint(0, 256, (2, 17))
    with pytest.warns(UserWarning, match="recompute_granularity") as jw:
        jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    with pytest.warns(UserWarning, match="recompute_granularity") as tw:
        tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    # no warning without recompute, nor in eval
    tm.config.use_recompute = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))


@pytest.mark.parametrize("scan,remat", [(True, False), (True, True),
                                        (False, True)])
def test_qwen2_scanned_and_unrolled_match_jax(scan, remat):
    jm, tm = _pair(jqwen2, tqwen2, "Qwen2Config", "Qwen2ForCausalLM",
                   scan_layers=scan, use_recompute=remat)
    ids = np.random.RandomState(3).randint(0, 256, (2, 33))
    _grads_match(tm, *_port_step(tm, ids), *_jax_step(jm, ids))


def test_qwen2_moe_never_scans(monkeypatch):
    _, tm = _pair(jqwen2, tqwen2, "Qwen2MoeConfig", "Qwen2MoeForCausalLM")
    assert tm.config.scan_layers
    calls = _count_scans(monkeypatch, tqwen2)
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (2, 9)))
    tm(ids, labels=ids)
    assert not calls


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_gpt2_goes_through_scan_layers_as_jax(dropout, monkeypatch):
    """Dropout 0: both packages scan (loss and gradients match); live
    dropout: neither does."""
    jm, tm = _pair(jgpt2, tgpt2, "GPT2Config", "GPT2ForCausalLM",
                   hidden_dropout_prob=dropout,
                   attention_dropout_prob=dropout)
    jscans = _count_scans(monkeypatch, importlib.import_module(
        "paddle_tpu.nn.scan"))
    tscans = _count_scans(monkeypatch, tgpt2)
    ids = np.random.RandomState(5).randint(0, 256, (2, 33))
    tres = _port_step(tm, ids)
    jres = _jax_step(jm, ids)
    assert len(tscans) == len(jscans) == int(dropout == 0.0)
    if dropout == 0.0:
        _grads_match(tm, *tres, *jres)


@pytest.mark.parametrize("masked", [False, True])
def test_ernie_goes_through_scan_layers_as_jax(masked, monkeypatch):
    """The encoder through scan_layers, the padding mask as its extra
    input: sequence and pooled outputs and the gradients of their sum
    match the JAX encoder's."""
    paddle.seed(0)
    jm = jernie.ErnieModel(jernie.ErnieConfig.tiny())
    jm.train()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        ternie.ErnieModel(ternie.ErnieConfig.tiny(), device="cpu"), arrays)
    tm.train()
    tscans = _count_scans(monkeypatch, ternie)
    rng = np.random.RandomState(6)
    ids = rng.randint(5, 512, (2, 11))
    mask = np.ones((2, 11), np.int64)
    if masked:
        mask[1, 7:] = 0
    jseq, jpool = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(
        mask) if masked else None)
    (jseq.sum() + jpool.sum()).backward()
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
          if p.grad is not None}
    tseq, tpool = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(
        mask) if masked else None)
    (tseq.sum() + tpool.sum()).backward()
    tg = convert.grads_to_numpy(tm)
    assert len(tscans) == 1
    np.testing.assert_allclose(tseq.detach().numpy(), jseq.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tpool.detach().numpy(), jpool.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert set(tg) == set(jg)
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
