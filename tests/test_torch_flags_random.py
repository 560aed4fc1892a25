"""The port's flags (``paddle_tpu_torch.framework.flags``) and global RNG
state (``framework.random``) against the JAX package's, on the CPU.

- Every JAX flag exists in the port with its default and type; both
  packages parse the same ``FLAGS_*`` environment the same way (each in
  a process of its own); ``flag_source``; ``on_change`` (the host trace
  flag turns the tracer on and off).
- The kernel-route flags: on (their default) the op goes through its
  kernel wrapper; off, it takes the plain version, and on the CPU both
  give the same numbers.
- ``seed`` repeats a draw, ``get_rng_state``/``set_rng_state`` round
  trip, and the tracker's seeds (``zlib.crc32`` of a name, ``base + 1000
  + i`` on a reseed) are the JAX package's. The streams themselves are
  ``torch.Generator``'s (ROADMAP §C).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import random as jrandom

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops.kernels import ce_chunk as kce
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from paddle_tpu_torch.ops.kernels import rms_norm as krms
from paddle_tpu_torch.ops.kernels import swiglu as ksw
from paddle_tpu_torch.profiler import get_tracer

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


@pytest.fixture
def flag_guard():
    saved = {reg: {n: dict(e) for n, e in reg._registry.items()}
             for reg in (jflags, tflags)}
    yield
    for reg, entries in saved.items():
        reg._registry.clear()
        reg._registry.update(entries)


# ---- the registry -----------------------------------------------------------

def test_every_jax_flag_with_its_default_and_type():
    # the names the JAX module defines, from a fresh process: a test file
    # run earlier in this one may have defined flags of its own
    names = set(_flags_in_a_process("paddle_tpu.framework"))
    assert len(names) == 24
    assert set(tflags._registry) == names
    for name in names:
        ent, port = jflags._registry[name], tflags._registry[name]
        assert port["default"] == ent["default"], name
        assert port["type"] is ent["type"], name
        assert (port["on_change"] is None) == (ent["on_change"] is None), name
        assert port["help"], name


ENV = {"FLAGS_check_nan_inf": "yes", "FLAGS_log_level": "7",
       "FLAGS_fraction_of_gpu_memory_to_use": "0.5",
       "FLAGS_allocator_strategy": "naive_best_fit",
       "FLAGS_enable_pallas_kernels": "0", "FLAGS_fused_swiglu": "off",
       "FLAGS_embedding_deterministic": "not-an-int",
       "FLAGS_use_pallas_ragged_attention": "0",
       "FLAGS_recompute_policy": "nothing_saveable",
       "FLAGS_flash_attn_block_q": "128"}


def _flags_in_a_process(module):
    code = (f"import json\nfrom {module} import flags\n"
            "print(json.dumps({n: [e['value'], e['source']] for n, e in "
            "flags._registry.items()}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", **ENV)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_environment_parsing_matches_jax():
    """A value that parses is taken (source "env"); one that does not
    leaves the default."""
    port = _flags_in_a_process("paddle_tpu_torch.framework")
    ref = _flags_in_a_process("paddle_tpu.framework")
    assert port == ref
    assert port["FLAGS_check_nan_inf"] == [True, "env"]
    assert port["FLAGS_embedding_deterministic"] == [0, "default"]
    assert port["FLAGS_flash_attn_block_q"] == [128, "env"]


def test_flag_source_and_set_flags(flag_guard):
    name = "FLAGS_fused_ce_chunk_v"
    for reg in (jflags, tflags):
        assert reg.flag_source(name) == "default"
        reg.set_flags({name: "512"})
        assert reg.flag(name) == 512 and reg.flag_source(name) == "set"


def test_on_change_toggles_the_host_tracer(flag_guard):
    tr = get_tracer()
    was = tr.enabled
    try:
        tflags.set_flags({"FLAGS_enable_host_trace": True})
        assert tr.enabled
        tflags.set_flags({"FLAGS_enable_host_trace": False})
        assert not tr.enabled
        seen = []
        tflags.define_flag("FLAGS_test_on_change", 1,
                           on_change=seen.append)
        tflags.set_flags({"FLAGS_test_on_change": 3})
        with tflags.scoped_default("FLAGS_test_on_change", 5):
            pass
        assert seen == [3]      # explicitly set: the scope does not apply
    finally:
        tr.enabled = was


# ---- the kernel routes ------------------------------------------------------

def _counting(monkeypatch, owner, attr, calls, tag):
    real = getattr(owner, attr)

    def wrapped(*a, **k):
        calls.append(tag)
        return real(*a, **k)
    monkeypatch.setattr(owner, attr, wrapped)


def _grad_of(fn, *ts):
    ts = [t.detach().requires_grad_() for t in ts]
    out = fn(*ts)
    out = out[0] if isinstance(out, tuple) else out
    out.sum().backward()
    return [out.detach()] + [t.grad for t in ts]


def _cases():
    g = torch.Generator().manual_seed(3)

    def r(*s):
        return torch.randn(*s, generator=g)
    x, w = r(6, 16), 1 + 0.1 * r(16)
    q, k = r(2, 9, 4, 16), r(2, 9, 2, 16)
    h, wv = r(10, 16), r(16, 40)
    labels = torch.randint(0, 40, (10,), generator=g)
    pools = [r(2, 5, 4, 16), r(2, 5, 4, 16)]
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    ctx = torch.tensor([5, 3], dtype=torch.int32)
    lengths = torch.tensor([2, 1], dtype=torch.int32)
    return [
        ("FLAGS_enable_pallas_kernels", (krms.RMSNormFunction, "apply"),
         (krms, "rms_norm_reference"),
         lambda: _grad_of(lambda a: F.rms_norm(a, w), x)),
        ("FLAGS_enable_pallas_kernels",
         (krms.RMSNormResidualFunction, "apply"),
         (krms, "rms_norm_residual_reference"),
         lambda: _grad_of(lambda a, b: F.fused_rms_norm_residual(a, b, w),
                          x, x.flip(0))),
        ("FLAGS_enable_pallas_kernels", (kfa, "flash_attention"),
         (F, "sdpa_reference"),
         lambda: _grad_of(lambda a, b, c: F.scaled_dot_product_attention(
             a, b, c, is_causal=True), q, k, k)),
        ("FLAGS_fused_swiglu", (ksw.SwiGLUFunction, "apply"),
         (ksw, "swiglu_reference"),
         lambda: _grad_of(F.swiglu, x, x.flip(1))),
        ("FLAGS_flash_attn_pallas_bwd", (kfa, "flash_attention_bwd"),
         (kfa, "flash_attention_bwd_reference"),
         lambda: _grad_of(lambda a, b, c: kfa.flash_attention(
             a, b, c, causal=True), q, k, k)),
        ("FLAGS_fused_ce_pallas_inner", (kce, "chunk_stats"),
         (kce, "chunk_stats_reference"),
         lambda: _grad_of(lambda a: fused_ce.fused_linear_cross_entropy(
             a, wv, labels), h)),
        ("FLAGS_use_pallas_paged_attention", (PA._kpa, "paged_attention"),
         (PA, "paged_attention_reference"),
         lambda: [PA.paged_attention(q[:, 0], *pools, tables, ctx)]),
        ("FLAGS_use_pallas_ragged_attention",
         (PA._krpa, "ragged_paged_attention"),
         (PA, "ragged_paged_attention_reference"),
         lambda: [PA.ragged_paged_attention(q[:, :2], *pools, tables, ctx,
                                            lengths)]),
    ]


@pytest.mark.parametrize("case", range(8))
def test_route_flag_takes_the_plain_path_only_when_off(case, flag_guard,
                                                       monkeypatch):
    flag, kernel, plain, call = _cases()[case]
    assert tflags.flag(flag)
    calls = []
    _counting(monkeypatch, *kernel, calls, "kernel")
    _counting(monkeypatch, *plain, calls, "plain")
    on = call()
    assert calls and calls[0] == "kernel", calls
    calls.clear()
    tflags.set_flags({flag: False})
    off = call()
    assert "kernel" not in calls and "plain" in calls, calls
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_chip_smoke_refuses_a_moved_kernel_route(flag_guard):
    """KERNEL_ROUTES names every route flag; chip_smoke's set-up check
    passes at their defaults and fails on one set off, on one set back on
    (an explicit choice), and on one from the environment."""
    from chip_smoke import check_kernel_routes
    assert set(tflags.KERNEL_ROUTES) == {case[0] for case in _cases()}
    check_kernel_routes()
    tflags.set_flags({"FLAGS_fused_swiglu": False})
    with pytest.raises(AssertionError, match="FLAGS_fused_swiglu=False"):
        check_kernel_routes()
    tflags.set_flags({"FLAGS_fused_swiglu": True})
    with pytest.raises(AssertionError, match=r"swiglu=True \(set\)"):
        check_kernel_routes()
    code = "import chip_smoke\nchip_smoke.check_kernel_routes()\n"
    env = dict(os.environ, FLAGS_use_pallas_ragged_attention="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "FLAGS_use_pallas_ragged_attention=1 (env)" in out.stderr


# ---- seed, the RNG state, the tracker ---------------------------------------

def test_seed_repeats_and_the_state_round_trips():
    x = torch.ones(4096)
    trandom.seed(5)
    a = F.dropout(x, 0.5)
    b = F.dropout(x, 0.5)
    trandom.seed(5)
    assert torch.equal(F.dropout(x, 0.5), a)
    assert not torch.equal(a, b)
    state = trandom.get_rng_state()
    c = F.dropout(x, 0.5)
    trandom.set_rng_state(state)
    assert torch.equal(F.dropout(x, 0.5), c)
    # seed reseeds torch's own default generator too
    trandom.seed(9)
    t0 = torch.rand(3)
    trandom.seed(9)
    assert torch.equal(torch.rand(3), t0)
    # the kept share and the scale are the JAX package's rule
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}


def test_tracker_seeds_are_the_jax_ones():
    jt, tt = jrandom.RNGStatesTracker(), trandom.RNGStatesTracker()
    for name in ("global_seed", "local_seed", "model_parallel_rng"):
        with jt.rng_state(name):
            pass
        with tt.rng_state(name):
            pass
        assert tt.states[name].initial_seed() == jt.states[name]._seed
    jt.add("data_rng", 77)
    tt.add("data_rng", 77)
    jt.reseed_all(123)
    tt.reseed_all(123)
    assert {n: g.initial_seed() for n, g in tt.states.items()} == \
        {n: g._seed for n, g in jt.states.items()}
    with pytest.raises(ValueError, match="already exists"):
        tt.add("data_rng", 1)


def test_rng_state_swaps_the_default_generator():
    tracker = trandom.get_rng_state_tracker()
    name = "test_flags_random_state"
    x = torch.ones(1024)
    trandom.seed(1)
    outside = F.dropout(x, 0.3)
    with tracker.rng_state(name):
        inside = F.dropout(x, 0.3)
    fresh = trandom.Generator(tracker.states[name].initial_seed())
    ref = torch.empty_like(x).bernoulli_(0.7, generator=fresh.generator())
    assert torch.equal(inside, x * ref / 0.7)
    trandom.seed(1)
    assert torch.equal(F.dropout(x, 0.3), outside)
    # seed() reseeds the named states as the JAX package does
    trandom.seed(40)
    names = sorted(tracker.states)
    assert tracker.states[name].initial_seed() == 40 + 1000 + names.index(
        name)
    del tracker.states[name]
    assert np.isfinite(outside.numpy()).all()
