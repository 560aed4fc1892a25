#!/usr/bin/env python3
"""The serving fleet's own instrumentation cost per delivery, on the CPU.

    JAX_PLATFORMS=cpu python tools/fleet_obs_overhead.py --package jax
    python tools/fleet_obs_overhead.py --package torch

Runs the traffic of the fleet's overhead pin (``tests/test_exposition.py``'s
``test_fleet_obs_overhead_under_pin``: a one-layer ``LlamaConfig.tiny()``
engine, two replicas, eight 4-8-token prompts of seed 3 asking 4 tokens
each, tenants t0/t1, a TTFT SLO rule) through the chosen package's
``ServingFleet``, ``--reps`` times after one warm-up run, and prints one
JSON line a run: the seconds the fleet booked as its own instrumentation
(``_obs_s``: SLO booking, the trace log, the timeline rebuild, per
delivery), the deliveries, the microseconds a delivery, the run's seconds
and ``obs_overhead_frac``. Each process imports one package only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(8, 16), greedy=True)


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as paddle
    from paddle_tpu.inference import ContinuousBatchingEngine, ServingFleet
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.profiler.slo import SLORule
    cfg = LlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.num_hidden_layers = 1
    paddle.seed(0)
    model = LlamaForCausalLM(cfg)
    model.eval()
    return (cfg, lambda: ContinuousBatchingEngine(model, **ENGINE),
            ServingFleet, SLORule)


def _torch():
    import dataclasses

    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            ServingFleet)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.profiler.slo import SLORule
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    return (cfg, lambda: ContinuousBatchingEngine(model, device="cpu",
                                                  **ENGINE),
            ServingFleet, SLORule)


def _prompts(vocab, n=8, seed=3, lo=4, hi=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi)),))
            .astype(np.int32) for _ in range(n)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--new-tokens", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    cfg, factory, ServingFleet, SLORule = (_jax if args.package == "jax"
                                           else _torch)()
    per = []
    for rep in range(args.reps + 1):
        fleet = ServingFleet(
            factory, num_replicas=2, retry_backoff_s=0.01,
            slo_rules=[SLORule("ttft", kind="ttft", threshold_ms=60_000,
                               target=0.9)])
        fids = [fleet.submit(p, args.new_tokens, tenant=f"t{i % 2}")
                for i, p in enumerate(_prompts(cfg.vocab_size))]
        done = fleet.run()
        assert len(done) == len(fids)
        if rep == 0:
            continue          # warm-up: compiles, first-tenant state
        us = fleet._obs_s / len(done) * 1e6
        per.append(us)
        print(json.dumps({
            "package": args.package, "rep": rep, "obs_s": fleet._obs_s,
            "deliveries": len(done), "us_per_delivery": us,
            "run_s": fleet._run_s,
            "obs_overhead_frac": fleet.gauges()["obs_overhead_frac"]}))
    print(json.dumps({"package": args.package,
                      "median_us_per_delivery": statistics.median(per),
                      "min_us_per_delivery": min(per)}))


if __name__ == "__main__":
    main()
