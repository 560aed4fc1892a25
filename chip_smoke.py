#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing its lines; any failure raises and the script exits
non-zero without printing a result:

1. set-up: TF32 off, the kernels built from paddle_tpu_torch/csrc with
   nvcc, the card's name and power limit;
2. each CUDA kernel against its plain PyTorch version at the shapes of
   Llama-3-8B (bf16, seeded inputs, trash page 0 filled with NaN), with
   its time, the plain version's, the bound and a library call's;
3. the serving path at full width: a 32-layer Llama-3-8B with seeded
   random weights served by the continuous-batching engine (12 requests
   through 8 slots), with the kernels' launch counters read around it;
4. parity: the same width at depth 2 in f32, greedy streams on the GPU
   against the CPU (plain versions), token for token;
5. the ``kernels`` JSON line, then the result line.

It imports neither JAX nor the JAX package, has no CPU fallback and
needs one GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
PEAK_BF16 = 989e12               # dense tensor-core bf16
PEAK_F32_CORES = 67e12           # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2 cache
WINDOWS = 5                      # timed windows per measurement


def log(msg):
    print(msg, flush=True)


def _replay_ms(graph, replays):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _arg_sets(args, iters, cycle=True):
    """Copies of ``args`` for successive calls to cycle through: enough
    that they span three times the L2 cache (at most ``iters``), so a
    timed call reads its inputs from device memory as the bound assumes,
    not from the L2 where the previous call of the loop left them. With
    ``cycle=False`` every call reads the same inputs."""
    import torch
    size = sum(a.numel() * a.element_size() for a in args
               if torch.is_tensor(a))
    copies = min(iters, max(1, -(-3 * L2_BYTES // max(size, 1))))
    if not cycle:
        copies = 1
    return [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args) for _ in range(copies - 1)]


class Timing(float):
    """A median time in ms that also carries the spread of its windows."""

    def __new__(cls, windows):
        windows = sorted(windows)
        t = super().__new__(cls, windows[len(windows) // 2])
        t.lo, t.hi = windows[0], windows[-1]
        return t

    def __format__(self, spec):
        return (f"{float(self):{spec}} [{self.lo:{spec}}-{self.hi:{spec}}]")


def time_ms(fn, args, iters=20, min_ms=50.0, cycle=True):
    """Device time of one call ``fn(*args)``: ``iters`` calls (cycling
    through copies of ``args``) captured in one CUDA graph, replayed
    between CUDA events. The graph takes the host (Python, ctypes,
    argument checks) out of the timing, which otherwise dominates kernels
    of a few microseconds. The replays fill ``min_ms`` once to bring the
    card's clocks up from idle, then ``WINDOWS`` times timed: the median
    of the windows, with their least and greatest."""
    import torch
    sets = _arg_sets(args, iters, cycle)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    once = _replay_ms(graph, 1)
    replays = max(3, min(2000, int(min_ms / max(once, 1e-3))))
    _replay_ms(graph, replays)
    t = Timing([_replay_ms(graph, replays) / (iters * replays)
                for _ in range(WINDOWS)])
    del graph, sets
    torch.cuda.empty_cache()
    return t


def eager_ms(fn, args, iters=20):
    """Time of one eager call ``fn(*args)``, host included: launches back
    to back between CUDA events; above the device time when Python is
    slower. Median of ``WINDOWS`` windows."""
    import torch
    sets = _arg_sets(args, iters)
    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    windows = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return Timing(windows)


def check_close(what, out, ref, tol):
    """Holds ``out`` against ``ref`` element by element: ``tol`` is a
    tensor of per-element limits. Returns the max abs error and the
    largest ratio of an element's error to its limit."""
    err = (out.float() - ref.float()).abs()
    ratio = (err / tol).max().item()
    if not (err <= tol).all():
        raise AssertionError(
            f"{what}: {int((err > tol).sum())} elements past their limit; "
            f"max abs err {err.max().item():.4g}, worst err/limit "
            f"{ratio:.3g}")
    return err.max().item(), ratio


def bound(n_bytes, ops, peak):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_setup():
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 throughout, as the tolerances of
    # phase 2 assume for the plain versions
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build()
    log(f"[setup] kernels built in {_build.build_seconds():.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[setup] {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return card


def phase_kernels(cfg, dev="cuda"):
    """Each kernel against its plain version at the 8B shapes."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.ops.kernels import rms_norm as krms
    from paddle_tpu_torch.ops.kernels import swiglu as ksw
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    H, I = cfg.hidden_size, cfg.intermediate_size
    res = {}

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(bf16)

    for name in ("rms_norm", "swiglu"):
        res[name] = {"max_abs_err": 0.0}
    for n in (8, 2048):
        x, w = rand(n, H), 1 + 0.1 * rand(H)
        y = krms.rms_norm(x, w, cfg.rms_norm_eps)
        ref = krms.rms_norm_reference(x, w, cfg.rms_norm_eps)
        # per element. Same rounding points as the plain version: the f32
        # statistics' summation order may move x*inv by one ulp, which the
        # product with w and its rounding carry to at most three ulps
        err, worst = check_close(f"rms_norm N={n}", y, ref,
                                 3 * BF16_ULP * ref.float().abs() + 1e-6)
        args = (x, w, cfg.rms_norm_eps)
        ms = time_ms(krms.rms_norm, args)
        eager = eager_ms(krms.rms_norm, args)
        plain = time_ms(krms.rms_norm_reference, args)
        lib = time_ms(lambda x, w, eps: tF.rms_norm(x, (H,), w, eps), args)
        b_ms, b_by = bound((2 * n * H + H) * 2, 4 * n * H, PEAK_F32_CORES)
        log(f"[kernels] rms_norm N={n} D={H}: max abs err {err:.3g} "
            f"(limit 3 ulps of each |ref|, worst err/limit {worst:.3g}) "
            f"kernel {ms:.4f} ms (eager {eager:.4f}) plain {plain:.4f} ms "
            f"library {lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if n == 2048:
            # the same inputs every call stay in the 50 MB L2: a time that
            # can fall below the HBM bound, kept only to show the effect
            warm = time_ms(krms.rms_norm, args, cycle=False)
            log(f"[kernels] rms_norm N={n}: {warm:.4f} ms re-reading the "
                f"same inputs from L2 (not kept)")
        r = res["rms_norm"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                 bound_ms=b_ms,
                 bound_by=b_by, shape=f"x[{n},{H}] bf16")

        g, u = rand(n, I) * 2, rand(n, I)
        out = ksw.swiglu(g, u)
        ref = ksw.swiglu_reference(g, u)
        # per element. The kernel rounds once from f32, the plain version
        # twice (silu, then the product): two ulps of each |ref|
        err, worst = check_close(f"swiglu N={n}", out, ref,
                                 2 * BF16_ULP * ref.float().abs() + 1e-6)
        # against silu(g)*u in f32 rounded once, as the kernel computes:
        # one ulp (the exp implementations differ in the last f32 bits)
        once = (tF.silu(g.float()) * u.float()).to(bf16)
        _, worst1 = check_close(f"swiglu N={n} vs f32 rounded once", out,
                                once, BF16_ULP * once.float().abs() + 1e-6)
        ms = time_ms(ksw.swiglu, (g, u))
        eager = eager_ms(ksw.swiglu, (g, u))
        plain = time_ms(ksw.swiglu_reference, (g, u))
        b_ms, b_by = bound(3 * n * I * 2, 5 * n * I, PEAK_F32_CORES)
        log(f"[kernels] swiglu N={n} I={I}: max abs err {err:.3g} (limit 2 "
            f"ulps of each |ref|, worst err/limit {worst:.3g}; against f32 "
            f"rounded once, limit 1 ulp, worst {worst1:.3g}) "
            f"kernel {ms:.4f} ms (eager {eager:.4f}) plain {plain:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by})")
        r = res["swiglu"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=None,
                 bound_ms=b_ms,
                 bound_by=b_by, shape=f"gate,up[{n},{I}] bf16")

    # ragged attention over a mixed batch: idle, decode, prefill chunks
    B, C, page, max_len = 8, 256, 16, 2048
    nh, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    mp = max_len // page
    P = B * mp + 1
    lengths = np.array([0, 1, 1, 17, 256, 256, 1, 100], np.int32)
    ctx = np.array([0, 1800, 700, 300, 0, 1000, 1200, 33], np.int32)
    rng = np.random.RandomState(7)
    tables = (rng.permutation(P - 1) + 1).reshape(B, mp).astype(np.int32)
    for b in range(B):     # table padding points at the trash page
        tables[b, -(-(ctx[b] + lengths[b]) // page):] = 0
    kp, vp = rand(kvh, P, page, d), rand(kvh, P, page, d)
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    q = rand(B, C, nh, d)
    tb = torch.from_numpy(tables).to(dev)
    ct = torch.from_numpy(ctx).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    args = (q, kp, vp, tb, ct, ln)
    out = krpa.ragged_paged_attention(*args)
    ref = krpa.ragged_paged_attention_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError("ragged attention: non-finite output (the NaN "
                             "trash page reached a row)")
    for b in range(B):
        if lengths[b] < C and out[b, lengths[b]:].abs().max().item() != 0:
            raise AssertionError(f"ragged attention: slot {b} rows past "
                                 f"its length are not zero")
    err, worst, worst1, err32, worst32 = ragged_checks(krpa, args, ref, out)
    ms = time_ms(krpa.ragged_paged_attention, args)
    eager = eager_ms(krpa.ragged_paged_attention, args)
    plain = time_ms(krpa.ragged_paged_attention_reference, args, iters=2)
    kv_keys = int(np.sum((ctx + lengths)[lengths > 0]))
    q_rows = int(lengths.sum())
    n_bytes = (q_rows * nh * d * 2 + B * C * nh * d * 2
               + 2 * kv_keys * kvh * d * 2)
    pairs = sum(int(ctx[b]) * int(lengths[b])
                + int(lengths[b]) * (int(lengths[b]) + 1) // 2
                for b in range(B))
    b_ms, b_by = bound(n_bytes, 4 * d * nh * pairs, PEAK_BF16)
    log(f"[kernels] ragged_paged_attention B={B} C={C} H={nh} KVH={kvh} "
        f"D={d} lengths={lengths.tolist()} ctx={ctx.tolist()}: bf16 max abs "
        f"err {err:.3g} (limit 2^-8*sum p|v| + 1 ulp of each |ref|, worst "
        f"err/limit {worst:.3g}; against the f32 plain version, limit 1 "
        f"ulp, worst {worst1:.3g}); f32 kernel max abs err {err32:.3g} "
        f"(limit 1e-5*sum p|v| + 1e-6, worst {worst32:.3g}) "
        f"kernel {ms:.4f} ms (eager {eager:.4f}) plain {plain:.4f} ms "
        f"bound {b_ms:.4f} ms ({b_by})")
    res["ragged_paged_attention"] = dict(
        max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain,
        library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q[{B},{C},{nh},{d}] pools[{kvh},{P},{page},{d}] bf16")
    return res


def ragged_checks(krpa, args, ref, out):
    """The ragged kernel held per element, three ways, against limits
    derived from where the two sides round. ``a = sum_i p_i |v_i|`` (the
    plain version in f32 over |v|) scales an output's rounding error.

    - bf16 kernel vs bf16 plain version: the plain version rounds each
      probability to bf16 (at most 2^-8 relative) before P.V, which moves
      an output by at most 2^-8 * a; each side then rounds its output
      (half an ulp each): 2^-8 * a + 1 ulp of |ref|.
    - bf16 kernel vs the plain version in f32 on the same (upcast)
      inputs: the kernel keeps everything in f32 but its output rounding,
      so 1 ulp of |ref| plus f32 noise.
    - f32 kernel vs f32 plain version: summation order and exp only,
      1e-5 * a + 1e-6. A key dropped or added on a row of n keys moves
      its output by about a / n, some 4e-4 at n = 1800: 50 times this.
    """
    q, kp, vp, tb, ct, ln = args
    f32 = [t.float() for t in (q, kp, vp)]
    a = krpa.ragged_paged_attention_reference(f32[0], f32[1], f32[2].abs(),
                                              tb, ct, ln).float()
    err, worst = check_close("ragged attention bf16", out, ref,
                             1.01 * (2 ** -8 * a + BF16_ULP
                                     * ref.float().abs()) + 1e-6)
    ref32 = krpa.ragged_paged_attention_reference(*f32, tb, ct, ln)
    _, worst1 = check_close("ragged attention bf16 vs f32 plain", out, ref32,
                            BF16_ULP * ref32.abs() + 1e-5 * a + 1e-6)
    out32 = krpa.ragged_paged_attention(*f32, tb, ct, ln)
    err32, worst32 = check_close("ragged attention f32", out32, ref32,
                                 1e-5 * a + 1e-6)
    del a, ref32, out32, f32
    return err, worst, worst1, err32, worst32


def phase_serve(cfg, dev="cuda", dtype=None):
    """Llama-3-8B at full width and depth through the engine."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.ops.kernels import rms_norm as krms
    from paddle_tpu_torch.ops.kernels import swiglu as ksw
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=dtype or torch.bfloat16,
                             seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] Llama-3-8B {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.2f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ContinuousBatchingEngine(model, num_slots=8, page_size=16,
                                   max_len=2048, prefill_chunk=256,
                                   decode_chunk=8, device=dev)
    pool_gb = sum(p.numel() * p.element_size() for p in eng.pools) / 1e9
    log(f"[serve] KV pool {pool_gb:.2f} GB ({eng.num_pages} pages)")
    rng = np.random.RandomState(42)
    # warm-up (cuBLAS handles, allocator) outside the counted run
    eng.add_request(rng.randint(0, cfg.vocab_size, 16), 4)
    eng.run()
    prompt_lens = rng.permutation(np.linspace(64, 1500, 12).astype(int))
    n_new = 32
    for n in prompt_lens:
        eng.add_request(rng.randint(0, cfg.vocab_size, int(n)), n_new)
    wrappers = {"rms_norm": krms.rms_norm, "swiglu": ksw.swiglu,
                "ragged_paged_attention": krpa.ragged_paged_attention}
    fw0, st0 = eng.stats["forwards"], eng.stats["steps"]
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = eng.stats["forwards"] - fw0
    if len(done) != 12:
        raise AssertionError(f"{len(done)} of 12 requests completed")
    bad = [(r.request_id, len(r.tokens)) for r in done
           if len(r.tokens) != n_new or r.finish_reason != "length"]
    if bad:
        raise AssertionError(f"requests without {n_new} tokens: {bad}")
    if len(eng._free_pages) != eng.num_pages - 1:
        raise AssertionError(f"free list {len(eng._free_pages)} of "
                             f"{eng.num_pages - 1} pages after the run")
    L = cfg.num_hidden_layers
    want = {"rms_norm": (2 * L + 1) * forwards, "swiglu": L * forwards,
            "ragged_paged_attention": L * forwards}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for "
                             f"{forwards} forwards")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve] 12 requests (prompts {sorted(prompt_lens.tolist())}, "
        f"{n_new} new each) in {wall:.2f} s: {12 * n_new / wall:.1f} "
        f"generated tok/s, {eng.stats['steps'] - st0} steps, {forwards} "
        f"forwards, "
        f"peak memory {peak:.2f} GB")
    log(f"[serve] launches {launches} (per forward: {2 * L + 1} rms_norm, "
        f"{L} swiglu, {L} attention)")
    del eng, model
    torch.cuda.empty_cache()
    return launches


def _top2_gap(model, tokens):
    """Top-2 logit gap of the next token after ``tokens`` (one slot,
    fresh pools), on the model's own device."""
    import torch
    cfg = model.config
    dev = model.llama.embed_tokens.weight.device
    page = 16
    pages = -(-len(tokens) // page)
    shape = (cfg.num_key_value_heads, pages + 1, page, cfg.head_dim)
    pools = [torch.zeros(shape, device=dev)
             for _ in range(2 * cfg.num_hidden_layers)]
    ids = torch.tensor([tokens], device=dev)
    tables = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    logits, _ = model(ids, pools, torch.zeros(1, dtype=torch.int32,
                                              device=dev),
                      (tables, torch.tensor([len(tokens)], device=dev)))
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_parity(cfg, dev="cuda"):
    """Depth 2, f32: greedy streams on the GPU and on the CPU."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM
    torch.set_num_threads(os.cpu_count() or 1)
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    t0 = time.perf_counter()
    cpu_model = LlamaForCausalLM(cfg2, device="cpu", seed=5)
    gpu_model = LlamaForCausalLM(cfg2, device=dev, seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    log(f"[parity] depth-2 f32 models built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (128, 77, 31, 100)]
    streams = {}
    for name, model in ((dev, gpu_model), ("cpu", cpu_model)):
        eng = ContinuousBatchingEngine(model, num_slots=4, page_size=16,
                                       max_len=256, prefill_chunk=128,
                                       decode_chunk=4, device=name)
        for p in prompts:
            eng.add_request(p, 16)
        t0 = time.perf_counter()
        done = sorted(eng.run(), key=lambda r: r.request_id)
        streams[name] = [r.tokens for r in done]
        log(f"[parity] {name}: {time.perf_counter() - t0:.1f} s")
    for i, (g, c) in enumerate(zip(streams[dev], streams["cpu"])):
        if g == c:
            continue
        j = next(k for k, (a, b) in enumerate(zip(g, c)) if a != b)
        gap = _top2_gap(cpu_model, list(prompts[i]) + c[:j])
        if gap >= 1e-3:
            raise AssertionError(
                f"request {i}: GPU and CPU streams diverge at token {j} "
                f"with a CPU top-2 gap of {gap:.3g}: {g} vs {c}")
        log(f"[parity] request {i} diverges at token {j} on a near tie "
            f"(CPU top-2 gap {gap:.3g} < 1e-3)")
    log(f"[parity] 4 greedy streams of 16 tokens: cuda vs cpu "
        f"{sum(g == c for g, c in zip(streams[dev], streams['cpu']))}/4 "
        f"identical")
    del gpu_model
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    t_start = time.perf_counter()
    phase_setup()
    res = phase_kernels(cfg)
    launches = phase_serve(cfg)
    phase_parity(cfg)
    sources = {
        "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/ops/pallas/rms_norm.py:38"),
        "swiglu": ("paddle_tpu_torch/csrc/swiglu.cu",
                   "paddle_tpu/ops/pallas/swiglu.py:39"),
        "ragged_paged_attention": (
            "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "paddle_tpu/ops/pallas/ragged_paged_attention.py:120"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = res[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "eager_ms": r["eager_ms"], "shape": r["shape"]})
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
