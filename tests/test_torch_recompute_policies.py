"""The port's five recompute policies (``FLAGS_recompute_policy``,
``paddle_tpu_torch.incubate.recompute``) against the JAX package's, on
the CPU.

Both sides run ``LlamaConfig.tiny()`` in f32 with the same weights
(bridged with ``convert.from_numpy_state_dict``), ``use_recompute=True``
and ``scan_layers=False``, on numpy ids from a seed; the loss must match
the JAX loss within 1e-5 (relative) and every gradient within rtol 1e-4,
atol 1e-6 (two f32 layers whose sums run in another order), as in
tests/test_torch_fused_training.py.

What each policy keeps is counted where torch's selective checkpointing
decides it: a policy wrapper counts the op outputs it keeps in the
forward (torch's non-reentrant checkpoint holds them in its own cache,
outside ``saved_tensors_hooks``), and a dispatch mode counts the ops the
backward re-runs. The flash attention forward is one operator
(``paddle_tpu_torch::flash_fwd``) whose implementation on the CPU is the
plain version, the stand-in for K7.
"""

import functools
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

# the modules (each package's incubate re-exports the function under
# the module's name)
jrecompute = importlib.import_module("paddle_tpu.incubate.recompute")
trecompute = importlib.import_module("paddle_tpu_torch.incubate.recompute")

torch.set_num_threads(1)

POLICIES = ("dots_saveable", "nothing_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable",
            "dots_and_flash_saveable")
FLASH = torch.ops.paddle_tpu_torch.flash_fwd.default


@pytest.fixture
def flag_guard():
    saved = [(reg, dict(reg._registry["FLAGS_recompute_policy"]))
             for reg in (jflags, tflags)]
    yield
    for reg, ent in saved:
        reg._registry["FLAGS_recompute_policy"] = ent


def _policy(name):
    jflags.set_flags({"FLAGS_recompute_policy": name})
    tflags.set_flags({"FLAGS_recompute_policy": name})


def _models(gran):
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.use_recompute = True
    cfg.recompute_granularity = gran
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.train()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = LlamaConfig.tiny()
    tcfg.scan_layers = False
    tcfg.use_recompute = True
    tcfg.recompute_granularity = gran
    tm = convert.from_numpy_state_dict(LlamaForCausalLM(tcfg, device="cpu"),
                                       arrays)
    tm.train()
    return jm, tm


def _ids(seed):
    return np.random.RandomState(seed).randint(0, 256, (2, 33))


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


@pytest.mark.parametrize("gran", ["full", "core_attn"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(policy, gran, flag_guard):
    _policy(policy)
    jm, tm = _models(gran)
    ids = _ids(3)
    jloss, jg = _jax_step(jm, ids)
    tloss, tg = _port_step(tm, ids)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg) and len(tg) == len(list(tm.parameters()))
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    # a policy changes what is kept, never a number of the port's step
    tm.config.use_recompute = False
    nloss, ng = _port_step(tm, ids)
    assert nloss == tloss
    for key in tg:
        np.testing.assert_array_equal(ng[key], tg[key], err_msg=key)


class _Reruns(TorchDispatchMode):
    """The ops the backward runs, by op."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _kept_and_rerun(tm, name, monkeypatch):
    """(ops whose outputs the policy keeps in the forward, by op; ops the
    backward runs, by op)."""
    kept = {}
    fn = trecompute.POLICIES[name]
    if fn is not None:
        inner = fn.args[0]

        def counting(ctx, op, *args, **kwargs):
            decision = inner(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision == CheckpointPolicy.MUST_SAVE:
                kept[op] = kept.get(op, 0) + 1
            return decision
        monkeypatch.setitem(trecompute.POLICIES, name, functools.partial(
            create_selective_checkpoint_contexts, counting))
    t = torch.from_numpy(_ids(4))
    _, loss = tm(t, labels=t)
    with _Reruns() as mode:
        loss.backward()
    tm.zero_grad(set_to_none=True)
    return kept, mode.ops


def test_policies_keep_nested_sets(flag_guard, monkeypatch):
    """At ``full`` granularity: everything keeps more than
    dots_and_flash, which keeps dots' products and the flash output,
    which dots does not keep; dots keeps at least what no-batch-dims keeps
    (the same here: the only products outside the flash operator are
    the Linear layers' ``aten.mm``), and nothing keeps nothing. The
    backward's re-run work falls in the reverse order, and only
    dots_and_flash and everything re-run no flash forward."""
    _, tm = _models("full")
    kept, reruns = {}, {}
    for name in POLICIES:
        _policy(name)
        k, r = _kept_and_rerun(tm, name, monkeypatch)
        kept[name], reruns[name] = sum(k.values()), sum(r.values())
        layers = tm.config.num_hidden_layers
        assert k.get(FLASH, 0) == (layers if name in (
            "dots_and_flash_saveable", "everything_saveable") else 0), name
        assert r.get(FLASH, 0) == (0 if name in (
            "dots_and_flash_saveable", "everything_saveable") else layers), \
            name
        if name == "dots_with_no_batch_dims_saveable":
            assert set(k) == {torch.ops.aten.mm.default}
    assert (kept["everything_saveable"] > kept["dots_and_flash_saveable"]
            > kept["dots_saveable"]
            >= kept["dots_with_no_batch_dims_saveable"]
            > kept["nothing_saveable"] == 0)
    assert (reruns["everything_saveable"] < reruns["dots_and_flash_saveable"]
            < reruns["dots_saveable"]
            <= reruns["dots_with_no_batch_dims_saveable"]
            < reruns["nothing_saveable"])


def test_unknown_policy_raises_the_jax_message(flag_guard):
    _policy("everything")
    with pytest.raises(ValueError) as jerr:
        jrecompute.checkpoint_with_policy(lambda x: x)
    _, tm = _models("full")
    t = torch.from_numpy(_ids(5))
    with pytest.raises(ValueError) as terr:
        tm(t, labels=t)
    assert str(terr.value) == str(jerr.value)
