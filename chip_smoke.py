#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing its lines; any failure raises and the script exits
non-zero without printing a result:

1. set-up: every kernel-route flag at its default (on), TF32 off, the
   kernels built from paddle_tpu_torch/csrc with nvcc, the card's name
   and power limit;
2. kernels: each CUDA kernel against its plain PyTorch version, with
   per-element limits, at the shapes of its path: the serving kernels at
   Llama-3-8B's (bf16, seeded inputs, trash page 0 filled with NaN), the
   training kernels (RMSNorm dx, SwiGLU backward, flash attention
   forward, dk/dv and dq) at the training phase's, the residual-fused
   RMSNorm pair at the full training step's and the fused CE's chunk
   kernels at the fit phase's, in bf16 and f32; with its time, the plain
   version's, the bound and a library call's; flash attention's bf16
   forward and backward launched twice must repeat their bits, and are
   timed at [2, 2049] and [4, 2049] with their rates; K10, K12 and K13
   too must repeat their bits; K12 also at the spec phase's verification
   step (8 slots of 5 real rows in a chunk of 64, pages of 32, at 16/8
   and 32/8 heads), timed with its bound;
   quant_kernels (run after moe_kernels, phase 19): K13 over int8 and
   fp8 pools (scales with NaN on the trash page) at K12's mixed batch,
   at 32/8 and 28/4 heads and at serve_quant's decode step (one token
   in each of 8 slots, its split plan, bits repeated), and K16 at decode
   shapes (8 and 64 sequences, contexts of 64-2048: its split plan, its
   registers and spills from ptxas, bits repeated) beside K12 at one
   token a slot (its keys split over CTAs), K12 there held against its
   plain version too;
3. serve: the serving path at full width: Llama-3-8B at 8 of its 32
   layers (the script's time limit) with seeded random weights served by
   the continuous-batching engine (12 requests through 8 slots, the prefix cache off) through the pipelined
   ``run()``, with the kernels' launch counters read around it, then two
   more requests under torch.profiler (device time by layer, K12's share
   of it, the attention kernels' device symbols, the idle share); then
   the same 12 requests and two profiled ones through serial ``step()``
   turns, whose greedy streams must equal run()'s (tok/s, idle share
   and ``prefill_overlap_frac`` of both);
4. serve_quant: the same model and traffic with ``kv_quant="int8"`` and
   ``"fp8"`` (K13): launches, streams against the bf16 pools' (greedy
   top-1 agreement), and a 1500-token prefill whose logits with
   quantized pools must stay within a stated bound of the bf16 pools';
   two requests profiled as in serve (K13's share);
5. capacity: the JAX bench's equal-byte A/B at that width: a bf16
   engine of 16 slots with 256 usable pages against an int8 engine with
   the same bytes of pools, each built as the bench builds it (prefix
   cache on, warm-up, cache reset), 12 requests (the bench's 24) of
   1024-1500 prompt tokens; the int8 engine must hold 1.7x the requests
   at once; the prefix cache's residency after the storm;
6. spec_8b: speculative decoding on that model, the first 4 of serve's
   requests (32 new each) at decode chunk 1: n-gram and oracle drafts'
   greedy streams must equal the plain engine's; the share equal to
   serve's decode-chunk-8 streams is printed;
7. weight_quant: that model built anew from its seed and converted to
   weight-only int8, then int4 (``quantize_for_serving``): layers, bytes
   and bytes saved, ``WeightOnlyLinear`` at the down_proj and lm_head
   shapes against its plain version per element, a 1500-token prefill's
   logits distance from bf16 and serve's traffic (launches counted,
   greedy agreement with serve's streams; reported, not gated);
8. prefix: the JAX bench's shared-prefix storm: Llama-1B (4 of its 16
   layers, bf16, seeded random weights), 8 slots, page 32, 32 requests (the
   bench's 64) sharing a 512-token prefix with tails of 0-63 tokens, 32
   new; one engine cold then warm, one with the cache off: identical greedy
   streams, a positive warm hit rate, a balanced page audit (hit rate,
   prefill tokens saved, COW forks, p99 TTFT of each);
9. overload: the JAX bench's overload section on that model: 48
   requests (the bench's 96; 48-192 prompt tokens, 32-96 new, priorities
   0-2) through an AdmissionController (queue 24, TTFT SLO 30 s) over an
   EngineSupervisor, a total SLO of 120 s: every accepted request
   completes or ends with a typed error, no page leaks (tok/s, p99 TTFT,
   shed share, preemption rate, goodput, restarts); then a poisoned
   request is quarantined while an innocent's stream equals its solo
   run;
10. spec: the JAX bench's spec section (bench.py:_cb_spec_bench) with its
   TPU configuration on that model: page 32, max_len 384, prefill chunk
   64, decode chunk 1, spec_k 4, n-gram drafts, prompts of 16 random
   tokens tiled 3 times, 32 new (the bench's 96); batches of 1, 4 and 8,
   a warm-up and 2 timed runs a leg: spec and plain tok/s, accept rate,
   ITL p99, greedy streams identical (launches counted); then
   self-speculative drafts, oracle drafts (accept rate 1.0) and
   adversarial ones (0.0) at batch 1 and int8 pools at batch 4, each
   with the plain streams;
11. parity: the Llama-3-8B width at depth 2 in f32, greedy streams on the
   GPU against the CPU (plain versions), token for token (a divergence
   only on a near tie), through the unified engine, the legacy engine
   and ``generate`` (scores within ``GEN_SCORE_TOL``); on the card,
   whether both engines' streams equal ``generate``'s;
12. quant_parity: the two engines with int8 pools;
13. decode: ``incubate.nn.functional.block_multihead_attention`` (K16)
   at Llama-3-8B's head layout over 32 layers' pools, 8 sequences, 8
   decode steps, then one more step under torch.profiler (its device
   time and K16's share of it);
14. train: Llama-3-8B width at 8 layers in bf16, the unfused stack
   (``FLAGS_fused_rmsnorm_residual`` off), the port's AdamW, 2 warm-up
   and 5 timed steps on [2, 2049] token ids (step time, tokens/s,
   model-FLOP share, peak memory, losses, launches per step), one step
   timed by part (forward, backward, optimizer) and one profiled (device
   time by layer, idle share), then 5 steps on one batch that must lower
   its loss;
15. train_parity: Llama-1B width at depth 2 in f32, one forward, backward
   and AdamW step on the card and on the CPU: loss, every gradient and
   every updated weight;
16. train_full: bench.py's headline training step on the port: the
   32-layer Llama-3-8B in bf16, [4, 2049] token ids, ``core_attn``
   recompute under ``dots_saveable``, the fused residual carry, the loss
   over full logits, forward and backward with the grads cleared and no
   optimizer; 2 warm-up and 5 timed steps, launches per step, one step
   profiled;
16b. train_2_4b: the JAX bench's other headline training configuration,
   ``LlamaConfig.llama_2_4b()`` (2560 wide, 32 layers, 20 heads over 4 KV
   heads, FFN 6912) at full width and depth in bf16 on [2, 2049] token
   ids, built after ``paddle_tpu_torch.seed(0)`` (its K1-K9 checked at
   these shapes among the kernel checks, phase 2): (a) the preset as
   written (core_attn on every second layer, the unrolled fused stack),
   5 timed steps: step time, MFU from ``profiler.cost``, peak memory,
   exact launches a step; (b) the five recompute policies at ``full``
   granularity: step time and peak memory each, losses equal bit for
   bit, sampled gradients within one bf16 ulp; (c) ``scan_layers=True``
   with core_attn: the granularity warning and the unrolled loss bit for
   bit, then its step time and peak memory at ``full`` beside (b)'s
   unrolled dots_saveable; (d) ``profiler.Profiler(targets=[GPU], scheduler=(1, 3),
   with_flops=True)``: its chrome trace names K1-K9; (e)
   ``amp.debugging``: ``check_numerics`` over the gradients,
   ``collect_operator_stats`` over a step, ``enable_check_nan_inf``
   quiet on a clean forward and raising on an injected inf;
17. fit: bench.py's fit bench on the port: Llama-1B at full depth in bf16
   through ``hapi.Model(net).prepare(SGD(1e-4), criterion).fit`` over 12
   batches of [8, 1025] for 2 epochs (the fused linear+CE on), epoch 1
   measured; launches per step, the fused CE tail against the unfused
   one, one fit of two steps profiled;
18. fused_parity: Llama-1B width at depth 2 in f32 on the card against
   the CPU: a labelled forward and backward with the fused carry and
   ``core_attn`` recompute, and ``fit(compiled=True)`` with SGD;
19. moe_kernels (run after phase 2's kernels): the grouped matmul (K14,
    K14 transposed) and its weight gradient (K15) against their plain
    versions, per element, at the wide training shape of qwen2_moe_a14b
    (bf16, timed, with torch._grouped_mm as the yardstick where it takes
    the shapes) and at the MoE bench width (f32 and bf16), a second
    launch repeating their bits; K14 in both modes at serve_moe's decode
    layout (32 real rows in 7808); K12 and K7-K9 at Qwen2's 28/4 heads,
    K12 also at serve_moe's decode step (one token in each of 8 slots,
    its split plan, bits repeated);
20. serve_moe: qwen2_moe_a14b at full width and half its depth (14 of
    28 layers, 60 experts, top-4, dropless) with seeded random weights through the
    engine, the serve phase's traffic, launch counters read around it;
21. moe_train_wide: the same width at 4 layers, [4, 2049] token ids,
    whole-layer recompute under ``dots_saveable``, the fused carry, aux
    0; forward and backward with the grads cleared (the JAX bench's MoE
    step): step time, tokens/s, activated-FLOP share, peak memory, the
    step-0 loss, launches per step, one step profiled;
22. moe_bench: bench.py's MoE step uncut (H 1024, 12 layers, 16 experts,
    top-2, every second layer saved whole), the same readings;
23. moe_parity: the MoE bench width at depth 2 in f32 on the card
    against the CPU: greedy serving streams, a labelled forward and
    backward (dropless, recompute), and the capacity path's loss;
24. the ``kernels`` JSON line, then the result line (after phase 43).

Three more paths run between those phases, two of the serving slice
and the training loop users run:

25. generate (``model.generate`` over dense caches; K1, K5, and K14 for
    the MoE model): on serve's Llama-3-8B after spec_8b, batch 8,
    prompts of 128, 64 new, greedy (launches), sampling with
    examples/serve_llama.py's settings twice (the same ids), and an eos
    run of one prompt that stops at its greedy stream's token; after
    spec, bench.py:_decode_bench on the prefix phase's Llama-1B
    (batch 8, prompt 128, 128 new where the bench takes 512, greedy, the
    long-minus-short protocol: ms/token/batch, tokens/s, launches per
    token, peak memory), then 32 tokens under ``torch.cuda.set_sync_debug_mode
    ("error")``; after serve_moe, qwen2_moe_a14b at batch 4, prompt
    64, 16 new (K14 launches);
26. legacy (after generate on the 8B model): the legacy engine
    (``unified=False``) on serve's model, geometry and 12 requests
    through ``run()`` (launches) and serial ``step()`` (the same
    streams): tok/s beside serve's (the JAX bench's A/B, telemetry),
    ``compiled_programs``, prefill waves, chunks, empty chunks, the
    greedy agreement with serve's streams (reported); then 4 requests
    over int8 pools (K13);
27. train_loop (after fused_parity): examples/train_gpt2.py's flow on
    the port at Llama-1B's full width and 2 of its 16 layers in bf16
    (the script's time limit): AdamW (decay off
    for norms by ``apply_decay_param_fun``) under
    ``LinearWarmup(CosineAnnealingDecay(3e-4, T_max=40), 10 steps from
    0)`` with ``nn.ClipGradByGlobalNorm(1.0)``, 40 steps of ``model(ids,
    labels=ids)``, backward, ``opt.step()``, ``opt.clear_grad()``,
    ``sched.step()`` on [8, 1024] windows of a 512-token Markov corpus
    (the mean of the last 5 losses must be 0.15 below the first 5's; the
    rate of every step must equal its closed form; step time by part,
    forward+backward, clip and update, from CUDA events; peak memory;
    launches per step of K1-K9, exact); ``Model.save_checkpoint`` before
    step 30, and a fresh model and optimizer loaded from it repeat
    steps 30-39; ``Model.save``/``load`` (predict's logits equal) and
    ``evaluate`` on 4 held-out batches; ``fit`` at depth 2 with
    ``save_dir``, resumed by a new Model (``resume=True``) to equal an
    uninterrupted fit; O1 and O2 ``train_batch`` at depth 2 on the card
    against the CPU; a ``GradScaler`` step with an inf in one gradient.

The model families, after moe_parity:

28. model_kernels: the kernels at the new paths' shapes against their
    plain versions per element, bits repeated, timed beside their
    bounds: K7-K9 at ERNIE's [16, 512] non-causal and GPT-2's [8, 1024]
    causal (12 heads, D 64); K12 at GPT-2's 12/12 heads and Llama-3-70B's
    64/8 (rep 8), a mixed and a decode step each; K1/K2 at widths 512,
    1536 and 5120, K5/K6 at 1536, 3072 and 12288; K14, K14-T and K15 at
    DeepSeek-V2's training layout (160 experts, top-6 of 4096 tokens, d
    5120, h 1536) and K14 both modes at its decode layout; K1 at [256,
    2048], K5 at [256, 5632] and K12 at 16/8 heads with pages of 32 (a
    mixed chunk of 32 and a decode step), as the fleet's and the HTTP
    phase's Llama-1B engines launch them;
29. gpt2: GPT-2 small: examples/train_gpt2.py's flow in f32 with dropout
    0.1 (40 AdamW steps on [8, 1024] windows of the Markov corpus, the
    loss 0.15 lower; save, load, a resumed step bit for bit), a bf16 step
    at dropout 0 (K7-K9 counted), ``generate`` at batch 8, the engine
    (12 requests, prompts 64-900; then int8 pools, K13; then weight-only
    int8), launches exact;
30. ernie: ERNIE-3.0-base in bf16: 10 AdamW steps of pretraining on [16,
    512] (K7-K9 non-causal, counted), a padded batch under
    ``attention_mask`` against each row's unpadded run, a classification
    step;
31. deepseek: DeepSeek-V2's published width: at depth 4 ``generate`` on
    the capacity path and dropless (K14), the latent cache's bytes; at
    depth 2 a dropless training step on [2, 2049] (the chunked MLA
    core), launches of K1-K6 and K14/K15 exact, profiled;
    bench.py:_moe_decode_bench at 128 new (the bench's 256; long minus
    short);
32. llama70: Llama-3-70B's width at depth 4 through the engine, 4 of
    serve's requests (K12 at rep 8);
33. model_parity: GPT-2 (2 heads), ERNIE and DeepSeek-V2 (capacity and
    dropless) at their tiny widths and depth 2 in f32, card against CPU:
    loss, every gradient, greedy ``generate`` streams, GPT-2's engine
    streams equal to its ``generate``'s.

The serving front door, after the decode bench on its Llama-1B (K1, K5,
K12):

34. fleet: bench.py:_cb_fleet_bench: 24 requests (the bench's 64)
    through one engine, then through a ``ServingFleet`` of 4 replicas
    (two SLO rules, two tenants) with replica 1 killed for good after 4
    steps (the bench's 8): every request delivered, the breaker open,
    the survivors' pages balanced;
    the bench's ``cb_fleet_*``, ``obs_slo_attainment``, ``slo_alerts``
    and ``obs_fleet_overhead_frac``, launches a forward (exact), the
    bf16 streams equal to the single engine's (a differing stream's
    first differing token and the top-2 gap there), the idle share over
    a profiled window of the same requests on the 3 survivors;
35. http: bench.py:_cb_http_bench: an engine-backed ``ApiServer`` driven
    by tools/load_harness.py as a separate process (16 SSE requests at
    once, the bench's 64 at concurrency 24; the engines warmed on 8
    others), one leg of each where the bench takes
    the best of 2 (``HTTP_REPS``: the time limit), beside the direct engine
    (``cb_http_*``); every request ok, a unary completion equal to the
    engine's tokens, /v1/models, /healthz and /statusz 200, a 429 with
    Retry-After when the admission queue is full;
36. fleet_parity: the fleet's traffic at depth 2 in f32: every stream
    equal to the single engine's through the kill, then with hedges,
    then with a ``scale_down`` forced through ``handoff()``;
37. observability: a 3-replica fleet at depth 2 with the flight recorder
    and a 2 s watchdog: /metrics and /statusz scraped while it serves
    (every scrape parses, replica-labelled families, no section error,
    no dump), two dispatches under ``set_sync_debug_mode("error")`` with
    the tracer on, ``wedge_replica`` (ejected, its requests delivered by
    its siblings, a complete post-mortem bundle) and a 3 s hang (one
    watchdog stall bundle).

The preemptible, elastic training path, after train_loop:

38. preempt: ``python -m paddle_tpu_torch.distributed.launch
    --max_preempt_restarts 1 --max_restarts 0`` runs this script as its
    worker (``--preempt-worker DIR``): Llama-1B's width at depth 2 in
    bf16 with AdamW, ``fit`` (the fused linear+CE; committed ``step_N``
    checkpoints, ``legacy_save=False``) over a map-style
    ``io.Dataset`` of 16 windows of 1025 byte ids of the repository's
    own .py/.md text, shuffled through 2 loader workers, 2 epochs of 4
    steps; round 0 sends itself a real SIGTERM after step 7 (step 2 of
    epoch 1), fit's guard commits the emergency checkpoint and the
    uncaught ``Preempted`` exits 75; the launcher relaunches once with
    ``PADDLE_RESUME_CHECKPOINT`` (committed, holding
    ``mid_epoch_step``) and round 1 finishes. Its losses and final
    weights must equal an uninterrupted run's in this process bit for
    bit (and a run with no workers); ``goodput.json`` must hold both
    rounds, with emergency_save and reshard above 0; launches per step
    of K1-K11 exact in all four runs. Printed: each round's seconds,
    ``elastic/emergency_save_ms``, the time to recover (SIGTERM to the
    first resumed loss), ``goodput_frac`` and its categories, the
    input wait per epoch with 2 workers and none, ``avg_step_ms`` and
    peak memory.

The process half of serving, after observability (each phase frees the
cached CUDA blocks before it spawns worker processes; the kernels were
built in the set-up, so a worker loads them; a worker's engine factory
is ``card_llama_engine``, the set-up's matmul settings, then
``inference.worker.llama_engine``):

39. procfleet: bench.py:_cb_procfleet_bench on the card: 4 ProcReplica
    worker processes, each a Llama-1B of 4 layers in bf16 (seed 0) with
    the fleet geometry, the fleet's 24 requests, replica 1's worker
    SIGKILLed twice (1 respawn, then its breaker); against the same
    requests and kills through the in-process fleet. Every fleet id
    delivered once, each survivor's audit balanced, each worker's init
    naming the card, launches a forward exact in each worker; tok/s,
    p99 TTFT, failover ms, respawns, spawn-to-ready seconds, the ratio
    to the in-process fleet and the share of streams equal to the
    single engine's; then 12 requests at concurrency 4 through an
    ``ApiServer`` on the survivors (tools/load_harness.py);
40. proc_parity: 2 workers at depth 2 in f32 (seed 1): a SIGKILL, two
    dropped and two corrupted frames, then a SIGSTOP (hung, ejected as
    wedged): every stream equal to the single engine's bit for bit;
41. disagg: 48 of bench.py:_cb_disagg_bench's 128 long_prompt_flood requests
    and role geometry at Llama-1B width, 8 layers, bf16: 1 prefill + 1
    decode worker against 2 colocated (migrations, pages and bytes
    moved, p99 migration ms, short-chat p99 TTFT of both legs, tok/s
    ratio, streams equal); a 224-token prompt's pages chunked through
    the wire past its 8 MiB frame cap and landed bit for bit; at depth 2
    in f32 the in-process disaggregated fleet's streams equal to the
    colocated engine's with f32 and int8 pools (K13);
42. autoscale: bench.py:_cb_autoscale_bench's flash_crowd leg at
    Llama-1B width, 8 layers: a FleetAutoscaler over 1-3 in-process
    replicas on the harness's TickClock against 3 fixed replicas: the
    scenario's attainment bar, nothing lost, a scale-up within 7 ticks
    of onset, fewer chip-seconds, every action in /statusz, launches
    exact;
43. tp: two ranks share the card through ``distributed.spawn`` (the
    backend rule takes gloo, the collectives through host buffers; each
    rank loads the kernels built in set-up). Three AdamW steps in f32 of
    Llama-1B's width at depth 1 split at mp 2, at mp 2 with sequence
    parallelism, under ZeRO stage 2 and stage 3 over sharding 2 and at
    dp 2 (the global batch split), and of the tiny Qwen2 and DeepSeek-V2
    at mp 2, each held to the unsharded port run of the same weights on
    the card (losses within ``TP_F32_RTOL``); then Llama-3-8B's width at
    4 of its 32 layers in bf16 at mp 2 ([1, 2048], the fused carry,
    core_attn recompute, the vocab-parallel fused CE over 64128-column
    shards), its first loss held to the unsharded run's (done first in
    this process, its memory freed before the spawn) within
    ``TP_BF16_RTOL``: ms a step, peak memory and K1-K11's launches a
    rank; rank 0 holds K7-K9 at 16 query and 4 KV heads and K10/K11 at
    the shard's chunks against their plain versions. Checkpoints across
    layouts: (a) each f32 case's ranks save model and optimizer
    (``hapi.Model.save_checkpoint``), and this process, beside the
    ranks, loads each into the unsharded model and takes steps 4-5,
    held to the unsharded run's own within ``TP_F32_RTOL[1]``; (b) the
    unsharded runs save after step 3 (the Llama's ``async_save``) and
    the ranks of each plain mp 2 case load that at mp 2 and take steps
    4-5, held the same; (c) the 8B's ranks save its model state
    (``TP_8B_SAVE_OPTIMIZER``) after step 3 and take step 4, and this
    process loads it at mp 1 and takes step 4 within ``TP_BF16_RTOL`` of
    theirs: the bytes and seconds of each save and load, the
    ``elastic/reshard_*`` gauges and the disk's free space. Then the
    same two ranks, after a second ``fleet.init`` with ``pp_degree`` 2,
    run the pipeline (``PipelineParallel`` over ``LlamaForCausalLMPipe``,
    each rank holding only its stage's layers, activations and
    gradients by p2p): Llama-1B's width at depth 4 in f32 under FThenB,
    1F1B, ZB-H1 and interleaved (V 2), ``TP_BATCH`` as 2 microbatches,
    held to the unpartitioned run of the same seed within
    ``TP_F32_RTOL``; the 1F1B case's checkpoint, which this process
    loads into ``LlamaForCausalLM`` and takes steps 4-5 within
    ``TP_F32_RTOL[1]`` of the unpartitioned run's own; the tiny
    Qwen2-MoE pipe (dropless: K14/K15; aux loss 0) within
    ``TP_F32_RTOL``; and Llama-3-8B's width at 4 layers in bf16 (fused
    carry, core_attn recompute, 1F1B, ids [4, 2049] as 4 microbatches)
    through ``PP_8B_STEPS`` AdamW steps within ``TP_BF16_RTOL`` of the
    unpartitioned run, with ms a step, peak memory and K1-K9's launches
    a rank (the ``pp`` entry of the kernels line). Then a third
    ``fleet.init`` at sep 2 (``sep_rank``, the ``sep`` entry) and a
    fourth at ep 2 (``ep_rank``, the ``ep`` entry): the f32 narrow
    Qwen2-MoE and tiny DeepSeek-V2 with E/ep experts a rank through 3
    AdamW steps and one SGD step at lr 0.1, held to the unpartitioned run
    within ``TP_F32_RTOL``, the Qwen2-MoE's ep 2 checkpoint resumed
    unpartitioned, the drop case (cf 2.0) held to the ranks' run on CPU
    tensors (the same kept slots), and ``qwen2_moe_a14b``'s width at 2
    layers in bf16 (cf 15, one SGD step and the next batch's loss within
    ``TP_BF16_RTOL``): ms a step, the all-to-alls' bytes and seconds,
    the banks' and peak GB and K1-K9's launches a rank.

It imports neither JAX nor the JAX package, has no CPU fallback and
needs one GPU.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

try:    # the port's Dataset for phase preempt's windows (its loader workers
    # unpickle them from this module); the script still fails in main()
    # where the port is missing
    from paddle_tpu_torch.io import Dataset as _PortDataset
except ImportError:
    _PortDataset = object

# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7
# the card's HBM rate and dense tensor-core bf16 peak: set by phase_setup
# from paddle_tpu_torch.profiler.cost.device_peaks (the H100 SXM's spec
# sheet figures, 3.35 TB/s and 989.4 TFLOP/s)
HBM_BYTES_PER_S = None
PEAK_BF16 = None
# nvidia-smi's "name, power limit": set by phase_setup
CARD = None
PEAK_F32_CORES = 67e12           # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2 cache
# the design of K7-K9 at D 64 and 128 and of K14 and K15 in bf16
# (csrc/flash_attention.cu, csrc/grouped_matmul.cu, hopper.cuh)
WGMMA_DESIGN = ("wgmma + TMA/mbarrier ring, warp-specialised: a producer "
                "warp, two consumer warpgroups (setmaxnreg 40/232)")
# the design of K12 and K13 with bf16 q at D 64 and 128
# (csrc/ragged_paged_attention.cu, tc::ragged_mma)
RAGGED_DESIGN = ("keys split over CTAs by a plan from the shapes, f32 "
                 "partials merged in split order by a second launch; "
                 "mma.sync m16n8k16 with P as bf16 hi + lo, a decode "
                 "block's tile keys split over the four warps; a "
                 "three-stage cp.async ring (K13: codes converted to a "
                 "bf16 work tile)")
# the design of K16 in bf16 at D 64 and 128 (csrc/paged_attention.cu,
# split::paged_split)
DECODE_DESIGN = ("keys split over the CTAs of a thread-block cluster by a "
                 "plan from the shapes, the partials merged in rank order "
                 "by rank 0 through distributed shared memory (one "
                 "launch); whole pages by 1-D bulk copies into a "
                 "three-stage mbarrier ring; f32 products on the CUDA "
                 "cores, each key's score folded over the lanes of its row")
WINDOWS = 3                      # timed windows per measurement


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


def attention_scales(q, k, v, grad, lse, delta, causal, scale=None):
    """Per-element error scales of flash attention's gradients: each
    gradient's products taken over magnitudes, in f32. With p the
    probabilities and |ds| <= p * (|dO.V^T| + |delta|) * scale:
    A_dv = p^T |dO|, A_dk = |ds|^T |q| (summed over the query heads of a
    kv head), A_dq = |ds| |k|. Rounding p or ds to bf16 moves a gradient
    by at most 2^-8 of its scale (bf16's unit roundoff); summation order
    in f32 by a few 1e-7.
    Returns (A_dq, A_dk, A_dv) in the layouts of dq, dk, dv."""
    import math

    import torch
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, gh = q.transpose(1, 2).float(), grad.transpose(1, 2).float()
    kh = k.repeat_interleave(rep, 2).transpose(1, 2).float()
    vh = v.repeat_interleave(rep, 2).transpose(1, 2).float()
    logits = (qh @ kh.transpose(-1, -2)) * s
    valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        valid = valid.tril(sk - sq)
    p = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
    del logits
    dsa = p * ((gh @ vh.transpose(-1, -2)).abs_() + delta.abs()[..., None])
    dsa *= s
    a_dv = p.transpose(-1, -2) @ gh.abs()
    del p
    a_dq = dsa @ kh.abs()
    a_dk = dsa.transpose(-1, -2) @ qh.abs()
    del dsa
    a_dk = a_dk.reshape(b, kvh, rep, sk, d).sum(2).transpose(1, 2)
    a_dv = a_dv.reshape(b, kvh, rep, sk, d).sum(2).transpose(1, 2)
    return a_dq.transpose(1, 2), a_dk, a_dv


def adam_first_step_limit(g_ref, g, w_ref, lr, eps=1e-8):
    """Per-element limit between two weights after one AdamW step from
    the same weights that differ only in their gradients (numpy arrays
    g_ref, g). The first step moves a weight by lr * g / (|g| + eps),
    whose slope is lr * eps / (|x| + eps)^2 for x between the two
    gradients (x may be 0 if their signs differ): that times |g - g_ref|,
    never more than 2 lr, plus f32 rounding of the weight."""
    same = np.sign(g) == np.sign(g_ref)
    low = np.where(same, np.minimum(np.abs(g), np.abs(g_ref)), 0.0)
    move = lr * eps * np.abs(g - g_ref) / (low + eps) ** 2
    return np.minimum(move, 2 * lr) + 1e-6 * np.abs(w_ref) + 1e-9


def bound(n_bytes, ops, peak):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ptxas_summary(build_log):
    """nvcc's ``-Xptxas -v`` output, one line per kernel: its name
    (demangled where ``c++filt`` is at hand), registers and spill bytes;
    the source file headers and any warning (C7512: wgmma serialised)."""
    import re
    import shutil
    lines, name, spill = [], None, ""
    for raw in build_log.splitlines():
        line = raw.strip()
        if line.startswith("==") or "warning" in line.lower():
            lines.append(line)
        elif "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line:
            spill = line
        elif re.search(r"Used \d+ registers", line) and name:
            regs = re.search(r"Used \d+ registers", line).group(0)
            lines.append((name, f"{regs}, {spill}"))
            name, spill = None, ""
    names = [x[0] for x in lines if isinstance(x, tuple)]
    if names and shutil.which("c++filt"):
        demangled = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   timeout=60).stdout.splitlines()
        table = dict(zip(names, demangled))
    else:
        table = {}

    def short(n):       # "void (anonymous namespace)::k<128>(args)": k<128>
        n = table.get(n, n).replace("(anonymous namespace)::", "")
        return n.split("(")[0].replace("void ", "", 1)
    return [x if isinstance(x, str) else f"{short(x[0])}: {x[1]}"
            for x in lines]


def check_kernel_routes():
    """Every kernel-route flag on at its define_flag default: a FLAGS_*
    environment variable or a set_flags call that moved an op onto its
    plain version fails the run before anything is measured."""
    from paddle_tpu_torch.framework import flags
    moved = [f"{name}={flags.flag(name)!r} ({flags.flag_source(name)})"
             for name in flags.KERNEL_ROUTES
             if not flags.flag(name) or flags.flag_source(name) != "default"]
    if moved:
        raise AssertionError("kernel-route flags not at their default (on): "
                             + ", ".join(moved))


def phase_setup():
    global HBM_BYTES_PER_S, PEAK_BF16, CARD
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    check_kernel_routes()
    from paddle_tpu_torch.profiler import cost
    peaks = cost.device_peaks()
    if peaks.kind == "unknown":
        raise AssertionError(f"profiler.cost has no peaks for "
                             f"{torch.cuda.get_device_name(0)!r}: the "
                             f"bounds need the card's")
    HBM_BYTES_PER_S, PEAK_BF16 = peaks.hbm_bw, peaks.flops
    # bf16 products accumulate in f32 throughout, as the tolerances of
    # phase 2 assume for the plain versions
    _matmul_settings()
    # built here, before any phase spawns a worker process: each worker
    # loads this library instead of running nvcc on every source at once
    _build.build()
    log(f"[setup] kernels built in {_build.build_seconds():.1f} s")
    for line in _ptxas_summary(_build.build_log()):
        log(f"[setup] {line}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = CARD = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; peaks from "
        f"profiler.cost ({peaks.kind}): {PEAK_BF16 / 1e12:.1f} TFLOP/s "
        f"bf16, {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return card


def _repeats(name, fn, args):
    """A second launch on the same inputs must give the same bits."""
    import torch
    a, b = fn(*args), fn(*args)
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: a second launch on the same "
                                 f"inputs gave other bits")


def norm_checks(n, D, eps, rand, kernels=("rms_norm", "rms_norm_dx"),
                tag="kernels"):
    """K1 (RMSNorm) and K2 (its dx), those named in ``kernels``, on x[n,
    D] against their plain versions per element: K1 in bf16, K2 in bf16
    and f32; in bf16 a second launch must repeat the bits, and each is
    timed beside its bound, K1 also beside ``torch.nn.functional.rms_norm``.
    Returns {kernel: entry}."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops.kernels import rms_norm as krms
    res = {}
    if "rms_norm" in kernels:
        x, w = rand(n, D), 1 + 0.1 * rand(D)
        ref = krms.rms_norm_reference(x, w, eps)
        # per element. Same rounding points as the plain version: the f32
        # statistics' summation order may move x*inv by one ulp, which the
        # product with w and its rounding carry to at most three ulps
        err, worst = check_close(f"rms_norm N={n} D={D}",
                                 krms.rms_norm(x, w, eps), ref,
                                 3 * BF16_ULP * ref.float().abs() + 1e-6)
        args = (x, w, eps)
        _repeats("rms_norm", krms.rms_norm, args)
        ms = time_ms(krms.rms_norm, args)
        eager = eager_ms(krms.rms_norm, args)
        plain = time_ms(krms.rms_norm_reference, args)
        lib = time_ms(lambda x, w, eps: tF.rms_norm(x, (D,), w, eps), args)
        b_ms, b_by = bound((2 * n * D + D) * 2, 4 * n * D, PEAK_F32_CORES)
        log(f"[{tag}] rms_norm N={n} D={D}: max abs err {err:.3g} (limit 3 "
            f"ulps of each |ref|, worst err/limit {worst:.3g}); a second "
            f"launch repeats it bit for bit; kernel {ms:.4f} ms (eager "
            f"{eager:.4f}) plain {plain:.4f} ms library {lib:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by})")
        res["rms_norm"] = dict(
            max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain,
            library_ms=lib, bound_ms=b_ms, bound_by=b_by,
            shape=f"x[{n},{D}] bf16")
        del x, w, ref, args
    if "rms_norm_dx" in kernels:
        for dtype in (torch.bfloat16, torch.float32):
            x, g = rand(n, D, dtype=dtype), rand(n, D, dtype=dtype)
            w = 1 + 0.1 * rand(D, dtype=dtype)
            ref = krms.rms_norm_dx_reference(x, w, g, eps)
            # per element. Both sides f32 inside and rounded once; the row
            # sums and the difference inv*g*w - x*c come in another order,
            # which moves dx by f32 noise of the magnitudes summed, mag (c
            # taken over |g*w*x|: the row sum may cancel); in bf16 that may
            # flip the output's rounding: one ulp of |ref|
            xf, gw = x.float(), g.float() * w.float()
            inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            c = inv ** 3 * (gw * xf).abs().mean(-1, keepdim=True)
            mag = (inv * gw).abs() + xf.abs() * c
            ulp = BF16_ULP if dtype == torch.bfloat16 else 1e-5
            err, worst = check_close(f"rms_norm_dx N={n} D={D} {dtype}",
                                     krms.rms_norm_dx(x, w, g, eps), ref,
                                     ulp * ref.float().abs() + 1e-5 * mag
                                     + 1e-6)
            del xf, gw, inv, c, mag, ref
            log(f"[{tag}] rms_norm_dx N={n} D={D} {dtype}: max abs err "
                f"{err:.3g} (limit {'1 ulp' if ulp == BF16_ULP else '1e-5'} "
                f"of each |ref| + 1e-5 of |inv*g*w| + |x*c|, worst "
                f"err/limit {worst:.3g})")
            if dtype == torch.float32:
                res["rms_norm_dx"]["max_abs_err_f32"] = err
                continue
            args = (x, w, g, eps)
            _repeats("rms_norm_dx", krms.rms_norm_dx, args)
            ms = time_ms(krms.rms_norm_dx, args)
            eager = eager_ms(krms.rms_norm_dx, args)
            plain = time_ms(krms.rms_norm_dx_reference, args)
            b_ms, b_by = bound((3 * n * D + D) * 2, 8 * n * D,
                               PEAK_F32_CORES)
            log(f"[{tag}] rms_norm_dx N={n} D={D}: a second launch repeats "
                f"it bit for bit; kernel {ms:.4f} ms (eager {eager:.4f}) "
                f"plain {plain:.4f} ms bound {b_ms:.4f} ms ({b_by})")
            res["rms_norm_dx"] = dict(
                max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=f"x,g[{n},{D}] bf16")
            del args
        del x, g, w
    torch.cuda.empty_cache()
    return res


def swiglu_checks(n, I, rand, kernels=("swiglu", "swiglu_bwd"),
                  tag="kernels"):
    """K5 (SwiGLU) and K6 (its backward), those named in ``kernels``, on
    [n, I] against their plain versions per element: K5 in bf16 (and
    against silu(g)*u in f32 rounded once), K6 in bf16 and f32; in bf16 a
    second launch must repeat the bits, and each is timed beside its
    bound. Returns {kernel: entry}."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops.kernels import swiglu as ksw
    bf16 = torch.bfloat16
    res = {}
    if "swiglu" in kernels:
        g, u = rand(n, I) * 2, rand(n, I)
        out = ksw.swiglu(g, u)
        ref = ksw.swiglu_reference(g, u)
        # per element. The kernel rounds once from f32, the plain version
        # twice (silu, then the product): two ulps of each |ref|
        err, worst = check_close(f"swiglu N={n} I={I}", out, ref,
                                 2 * BF16_ULP * ref.float().abs() + 1e-6)
        # against silu(g)*u in f32 rounded once, as the kernel computes:
        # one ulp (the exp implementations differ in the last f32 bits)
        once = (tF.silu(g.float()) * u.float()).to(bf16)
        _, worst1 = check_close(f"swiglu N={n} I={I} vs f32 rounded once",
                                out, once, BF16_ULP * once.float().abs()
                                + 1e-6)
        del out, ref, once
        _repeats("swiglu", ksw.swiglu, (g, u))
        ms = time_ms(ksw.swiglu, (g, u))
        eager = eager_ms(ksw.swiglu, (g, u))
        plain = time_ms(ksw.swiglu_reference, (g, u))
        b_ms, b_by = bound(3 * n * I * 2, 5 * n * I, PEAK_F32_CORES)
        log(f"[{tag}] swiglu N={n} I={I}: max abs err {err:.3g} (limit 2 "
            f"ulps of each |ref|, worst err/limit {worst:.3g}; against f32 "
            f"rounded once, limit 1 ulp, worst {worst1:.3g}); a second "
            f"launch repeats it bit for bit; kernel {ms:.4f} ms (eager "
            f"{eager:.4f}) plain {plain:.4f} ms bound {b_ms:.4f} ms "
            f"({b_by})")
        res["swiglu"] = dict(
            max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain,
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"gate,up[{n},{I}] bf16")
        del g, u
    if "swiglu_bwd" in kernels:
        for dtype in (bf16, torch.float32):
            gate, up = 2 * rand(n, I, dtype=dtype), rand(n, I, dtype=dtype)
            go = rand(n, I, dtype=dtype)
            dg, du = ksw.swiglu_bwd(gate, up, go)
            rg, ru = ksw.swiglu_bwd_reference(gate, up, go)
            # per element: the same f32 formula rounded once on both
            # sides; the exp implementations differ in the last f32 bits,
            # which may flip a bf16 rounding: one ulp (f32: 1e-5 of |ref|)
            ulp = BF16_ULP if dtype == bf16 else 1e-5
            err, worst = check_close(f"swiglu_bwd dgate N={n} I={I} {dtype}",
                                     dg, rg, ulp * rg.float().abs() + 1e-6)
            err2, worst2 = check_close(f"swiglu_bwd dup N={n} I={I} {dtype}",
                                       du, ru, ulp * ru.float().abs() + 1e-6)
            del dg, du, rg, ru
            log(f"[{tag}] swiglu_bwd N={n} I={I} {dtype}: max abs err "
                f"{max(err, err2):.3g} (limit {ulp:.3g} of each |ref|, worst "
                f"err/limit {max(worst, worst2):.3g})")
            if dtype == torch.float32:
                res["swiglu_bwd"]["max_abs_err_f32"] = max(err, err2)
                continue
            args = (gate, up, go)
            _repeats("swiglu_bwd", ksw.swiglu_bwd, args)
            ms = time_ms(ksw.swiglu_bwd, args)
            eager = eager_ms(ksw.swiglu_bwd, args)
            plain = time_ms(ksw.swiglu_bwd_reference, args)
            b_ms, b_by = bound(5 * n * I * 2, 12 * n * I, PEAK_F32_CORES)
            log(f"[{tag}] swiglu_bwd N={n} I={I}: a second launch repeats "
                f"it bit for bit; kernel {ms:.4f} ms (eager {eager:.4f}) "
                f"plain {plain:.4f} ms bound {b_ms:.4f} ms ({b_by})")
            res["swiglu_bwd"] = dict(
                max_abs_err=max(err, err2), ms=ms, eager_ms=eager,
                plain_ms=plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, shape=f"gate,up,grad[{n},{I}] bf16")
            del args
        del gate, up, go
    torch.cuda.empty_cache()
    return res


def phase_kernels(cfg, dev="cuda"):
    """Each kernel against its plain version at the 8B shapes."""
    import torch
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, I = cfg.hidden_size, cfg.intermediate_size
    res = {}

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    for n in (8, 2048):
        for r in (norm_checks(n, H, cfg.rms_norm_eps, rand, ("rms_norm",)),
                  swiglu_checks(n, I, rand, ("swiglu",))):
            for name, entry in r.items():
                entry["max_abs_err"] = max(entry["max_abs_err"], res.get(
                    name, {}).get("max_abs_err", 0.0))
                res[name] = entry

    # ragged attention over a mixed batch: idle, decode, prefill chunks
    B, C, page, max_len = 8, 256, 16, 2048
    nh, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    mp = max_len // page
    P = B * mp + 1
    lengths = np.array([0, 1, 1, 17, 256, 256, 1, 100], np.int32)
    ctx = np.array([0, 1800, 700, 300, 0, 1000, 1200, 33], np.int32)
    tables = _mixed_tables(B, P, mp, page, ctx, lengths, 7)
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
    if not torch.equal(krpa.ragged_paged_attention(*args), out):
        raise AssertionError("ragged attention: a second launch on the same "
                             "inputs gave other bits")
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
        f"(limit 1e-5*sum p|v| + 1e-6, worst {worst32:.3g}); a second "
        f"launch repeats it bit for bit; split plan "
        f"{krpa.split_plan(B, C, kvh, nh // kvh, d, mp * page)} "
        f"kernel {ms:.4f} ms (eager {eager:.4f}) plain {plain:.4f} ms "
        f"bound {b_ms:.4f} ms ({b_by})")
    res["ragged_paged_attention"] = dict(
        max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain,
        library_ms=None,
        bound_ms=b_ms, bound_by=b_by, design=RAGGED_DESIGN,
        shape=f"q[{B},{C},{nh},{d}] pools[{kvh},{P},{page},{d}] bf16",
        verify=k12_spec_shapes(cfg, rand, dev))
    return res


def _spec_geometry(B=8, rows=5, page=32, max_len=384):
    """The spec phase's attention inputs: B decoding slots, each with its
    pending token and 4 drafts (``rows`` real rows) inside a chunk of 64,
    pages of 32, contexts 48-300. Returns (pages a row, pool pages,
    lengths, ctx)."""
    mp = max_len // page
    return (mp, B * mp + 1, np.full(B, rows, np.int32),
            np.linspace(48, 300, B).astype(np.int32))


def k12_spec_shapes(cfg, rand, dev, B=8, C=64, page=32):
    """K12 at the spec phase's shapes: the verification step (8 slots of 5
    real rows in a chunk of 64) at Llama-1B's 16/8 heads and Llama-3-8B's
    32/8 (D 128), and the self-speculative draft's micro-step (one slot,
    one row, ctx 96) at 16/8: each against its plain version per element
    (``ragged_checks``), a second launch repeating its bits, timed with
    its bound. Returns {"16/8": entry, "32/8": entry, "draft 16/8":
    entry}."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    mp, _, lengths, ctx = _spec_geometry(B, page=page)
    cfg1b = LlamaConfig.llama_1b()
    out_entries = {}
    for tag, model_cfg, b, c, ln_np, ctx_np in (
            ("", cfg1b, B, C, lengths, ctx), ("", cfg, B, C, lengths, ctx),
            ("draft ", cfg1b, 1, 1, np.ones(1, np.int32),
             np.array([96], np.int32))):
        nh, kvh, d = (model_cfg.num_attention_heads,
                      model_cfg.num_key_value_heads, model_cfg.head_dim)
        rows = int(ln_np[0])
        p = b * mp + 1
        tables = _mixed_tables(b, p, mp, page, ctx_np, ln_np, 21)
        kp, vp = rand(kvh, p, page, d), rand(kvh, p, page, d)
        kp[:, 0] = float("nan")
        vp[:, 0] = float("nan")
        q = rand(b, c, nh, d)
        args = (q, kp, vp, *(torch.from_numpy(a).to(dev)
                              for a in (tables, ctx_np, ln_np)))
        what = f"K12 at the {tag or 'verify '}shape {nh}/{kvh}"
        out = krpa.ragged_paged_attention(*args)
        ref = krpa.ragged_paged_attention_reference(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or out[:, rows:].any():
            raise AssertionError(f"{what}: non-finite output or rows past "
                                 f"a slot's length not zero")
        err, worst, worst1, _, worst32 = ragged_checks(krpa, args, ref, out)
        if not torch.equal(krpa.ragged_paged_attention(*args), out):
            raise AssertionError(f"{what}: a second launch gave other bits")
        ms = time_ms(krpa.ragged_paged_attention, args)
        plain = time_ms(krpa.ragged_paged_attention_reference, args,
                        iters=2)
        keys = int(np.sum(ctx_np + ln_np))
        pairs = sum(int(x) * rows + rows * (rows + 1) // 2 for x in ctx_np)
        b_ms, b_by = bound(b * rows * nh * d * 2 + b * c * nh * d * 2
                           + 2 * keys * kvh * d * 2, 4 * d * nh * pairs,
                           PEAK_BF16)
        plan = krpa.split_plan(b, c, kvh, nh // kvh, d, mp * page)
        log(f"[kernels] ragged_paged_attention at the "
            f"{tag or 'verify '}shape B={b} C={c} ({rows} real rows a slot) "
            f"H={nh} KVH={kvh} D={d} page {page} ctx {ctx_np.tolist()}: "
            f"split plan {plan}; bf16 max abs err {err:.3g} (limit "
            f"2^-8*sum p|v| + 1 ulp of each |ref|, worst err/limit "
            f"{worst:.3g}; against the f32 plain version {worst1:.3g}; f32 "
            f"kernel {worst32:.3g}); a second launch repeats it bit for "
            f"bit; kernel {ms:.4f} ms plain {plain:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of the time)")
        out_entries[f"{tag}{nh}/{kvh}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, split_plan=list(plan),
            shape=f"q[{b},{c},{nh},{d}] ({rows} rows a slot) pools"
                  f"[{kvh},{p},{page},{d}] bf16, ctx "
                  f"{int(ctx_np.min())}-{int(ctx_np.max())}")
        del kp, vp, q, args, out, ref
        torch.cuda.empty_cache()
    return out_entries


def k13_verify_shape(cfg, rand, dev, B=8, C=64, page=32):
    """K13 at the spec phase's verification step over int8 and fp8 pools,
    on K12's verify inputs (``_spec_geometry``) at Llama-1B's 16/8 heads
    (the spec phase's int8 leg) and Llama-3-8B's 32/8: against its plain
    version per element at the quant_kernels limits, a second launch
    repeating its bits, timed with its bound. Returns {"int8 16/8":
    entry, ...}."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    mp, P, lengths, ctx = _spec_geometry(B, page=page)
    rows = int(lengths[0])
    out_entries = {}
    for model_cfg in (LlamaConfig.llama_1b(), cfg):
        nh, kvh, d = (model_cfg.num_attention_heads,
                      model_cfg.num_key_value_heads, model_cfg.head_dim)
        tb, ct, ln = (torch.from_numpy(a).to(dev) for a in (
            _mixed_tables(B, P, mp, page, ctx, lengths, 22), ctx, lengths))
        kf, vf = rand(kvh, P, page, d).float(), rand(kvh, P, page, d).float()
        q = rand(B, C, nh, d)
        for mode in QUANT_MODES:
            kc, ks = PA.quantize_kv(kf, _pool_dtype(mode))
            vc, vs = PA.quantize_kv(vf, _pool_dtype(mode))
            ks[:, 0] = vs[:, 0] = float("nan")
            if mode == "fp8":
                kc.view(torch.uint8)[:, 0] = 0x7F
                vc.view(torch.uint8)[:, 0] = 0x7F
            a = krpa.ragged_paged_attention_reference(
                q.float(), PA.dequantize_pages(kc, ks),
                PA.dequantize_pages(vc, vs).abs(), tb, ct, ln).float()
            args = (q, kc, vc, ks, vs, tb, ct, ln)
            what = f"K13 {mode} at the verify shape {nh}/{kvh}"
            out = krpa.ragged_paged_attention_quant(*args)
            ref = _k13_plain(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all() or out[:, rows:].any():
                raise AssertionError(f"{what}: non-finite output or rows "
                                     f"past a slot's length not zero")
            # the quant_kernels limit: both sides dequantize the same
            # codes and keep f32 probabilities (1e-5 * a), one rounding of
            # each bf16 output (1 ulp of |ref|)
            err, worst = check_close(
                what, out, ref, 1e-5 * a + BF16_ULP * ref.float().abs()
                + 1e-6)
            if not torch.equal(krpa.ragged_paged_attention_quant(*args),
                               out):
                raise AssertionError(f"{what}: a second launch gave other "
                                     f"bits")
            ms = time_ms(krpa.ragged_paged_attention_quant, args)
            plain = time_ms(_k13_plain, args, iters=2)
            keys = int(np.sum(ctx + lengths))
            pairs = sum(int(x) * rows + rows * (rows + 1) // 2 for x in ctx)
            b_ms, b_by = bound(B * rows * nh * d * 2 + B * C * nh * d * 2
                               + 2 * keys * kvh * (d + 4),
                               4 * d * nh * pairs, PEAK_BF16)
            log(f"[quant_kernels] ragged_paged_attention_quant {mode} at "
                f"the verify shape B={B} C={C} ({rows} real rows a slot) "
                f"H={nh} KVH={kvh} D={d} page {page} ctx {ctx.tolist()}: "
                f"max abs err {err:.3g} (limit 1e-5*sum p|v| + 1 ulp of "
                f"|ref| + 1e-6, worst err/limit {worst:.3g}); a second "
                f"launch repeats it bit for bit; kernel {ms:.4f} ms plain "
                f"{plain:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
                f"{100 * b_ms / ms:.1f}% of the time)")
            out_entries[f"{mode} {nh}/{kvh}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"q[{B},{C},{nh},{d}] ({rows} rows a slot) bf16, "
                      f"{mode} pools[{kvh},{P},{page},{d}] + f32 scales, "
                      f"ctx 48-300")
            del kc, vc, ks, vs, a, args, out, ref
        del kf, vf, q
        torch.cuda.empty_cache()
    return out_entries


def phase_train_kernels(cfg, batch=2, seq=2049, dev="cuda"):
    """The training kernels K2, K6, K7, K8 and K9 against their plain
    versions at the shapes of the training phase (batch x seq tokens of
    Llama-3-8B width), in bf16 (timed) and in f32."""
    import torch
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(4321)
    H, I = cfg.hidden_size, cfg.intermediate_size
    nh, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    n, eps = batch * seq, cfg.rms_norm_eps
    res = {}

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    res.update(norm_checks(n, H, eps, rand, ("rms_norm_dx",)))
    res.update(swiglu_checks(n, I, rand, ("swiglu_bwd",)))
    torch.cuda.empty_cache()
    res.update(flash_checks(batch, seq, nh, kvh, d, rand, wide_batch=4))
    return res


def phase_fused_kernels(cfg, n_res=4 * 2049, n_ce=8 * 1024, vc=1024,
                        dev="cuda"):
    """K3/K4 at the full training step's shape (x/res [n_res, H]) and
    K10/K11 at the fit phase's logits block ([n_ce, vc]), each in bf16
    (timed) and f32 against its plain version, per element."""
    import torch
    from paddle_tpu_torch.ops.kernels import ce_chunk as kce
    from paddle_tpu_torch.ops.kernels import rms_norm as krms
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(2468)
    H, eps, n = cfg.hidden_size, cfg.rms_norm_eps, n_res
    res = {}

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=gen)).to(
            dtype)

    def record(name, err, dtype, ms_fn, args, plain_fn, n_bytes, ops, shape):
        if dtype == torch.float32:
            res[name]["max_abs_err_f32"] = max(
                res[name].get("max_abs_err_f32", 0.0), err)
            return
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "ms" in r:
            return
        ms = time_ms(ms_fn, args)
        eager = eager_ms(ms_fn, args)
        plain = time_ms(plain_fn, args)
        b_ms, b_by = bound(n_bytes, ops, PEAK_F32_CORES)
        r.update(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=None,
                 bound_ms=b_ms, bound_by=b_by, shape=shape)
        log(f"[kernels] {name}: kernel {ms:.4f} ms (eager {eager:.4f}) "
            f"plain {plain:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / ms:.1f}% of the time); no single PyTorch call "
            f"computes it")

    # K3 and K4: RMSNorm + residual
    for dtype in (torch.bfloat16, torch.float32):
        x, rs = rand(n, H, dtype=dtype), rand(n, H, dtype=dtype)
        w = 1 + 0.1 * rand(H, dtype=dtype)
        y, r = krms.rms_norm_residual(x, rs, w, eps)
        ry, rr = krms.rms_norm_residual_reference(x, rs, w, eps)
        torch.cuda.synchronize()
        # r: the add rounds once in the input dtype on both sides: exact
        if not torch.equal(r, rr):
            raise AssertionError(f"rms_norm_residual {dtype}: r is not "
                                 f"x + res")
        # y as K1: the statistics' order may move r*inv by one ulp, which
        # the product with w carries to three ulps of |y| (f32: 1e-5)
        ulp = BF16_ULP if dtype == torch.bfloat16 else 1e-5 / 3
        err, worst = check_close(f"rms_norm_residual {dtype}", y, ry,
                                 3 * ulp * ry.float().abs() + 1e-6)
        log(f"[kernels] rms_norm_residual N={n} D={H} {dtype}: r exact, y "
            f"max abs err {err:.3g} (limit {3 * ulp:.3g} of each |ref|, "
            f"worst err/limit {worst:.3g})")
        elt = x.element_size()
        record("rms_norm_residual", err, dtype,
               krms.rms_norm_residual, (x, rs, w, eps),
               krms.rms_norm_residual_reference, (4 * n * H + H) * elt,
               6 * n * H, f"x,res[{n},{H}] bf16")
        del y, ry, rr, x, rs
        gy, gr = rand(n, H, dtype=dtype), rand(n, H, dtype=dtype)
        dh = krms.rms_norm_residual_dh(r, w, gy, gr, eps)
        ref = krms.rms_norm_residual_dh_reference(r, w, gy, gr, eps)
        torch.cuda.synchronize()
        # both f32 inside and rounded once; the row sums and the terms
        # inv*gy*w - r*c + gr come in another order, which moves dh by f32
        # noise of the magnitudes summed; in bf16 that may flip the
        # output's rounding: one ulp of |ref|
        rf, gw = r.float(), gy.float() * w.float()
        inv = torch.rsqrt(rf.square().mean(-1, keepdim=True) + eps)
        c = inv ** 3 * (gw * rf).abs().mean(-1, keepdim=True)
        mag = (inv * gw).abs() + rf.abs() * c + gr.float().abs()
        del rf, gw, inv, c
        ulp = BF16_ULP if dtype == torch.bfloat16 else 1e-5
        err, worst = check_close(f"rms_norm_residual_dh {dtype}", dh, ref,
                                 ulp * ref.float().abs() + 1e-5 * mag + 1e-6)
        del mag
        log(f"[kernels] rms_norm_residual_dh N={n} D={H} {dtype}: max abs "
            f"err {err:.3g} (limit {ulp:.3g} of each |ref| + 1e-5 of |inv*"
            f"gy*w| + |r*c| + |gr|, worst err/limit {worst:.3g})")
        record("rms_norm_residual_dh", err, dtype,
               krms.rms_norm_residual_dh, (r, w, gy, gr, eps),
               krms.rms_norm_residual_dh_reference, (4 * n * H + H) * elt,
               10 * n * H, f"r,gy,gr[{n},{H}] bf16")
        del r, w, gy, gr, dh, ref
        torch.cuda.empty_cache()

    # K10 and K11 on one fit-phase logits block; lo = 768 is the clamped
    # tail chunk's overlap at vc = 1024 for V = 32000 and V = 128256
    n = n_ce
    for dtype in (torch.bfloat16, torch.float32):
        for lo in (0, 768):
            logits = rand(n, vc, dtype=dtype, scale=3.0)
            local = torch.randint(lo, vc, (n,), device=dev, generator=gen,
                                  dtype=torch.int32)
            # labels in another chunk (below 0, at or past vc), in the
            # overlap prefix and at both ends of the chunk's own columns
            local[:6] = torch.tensor([-7, vc, 5 * vc, max(lo - 1, 0), lo,
                                      vc - 1], dtype=torch.int32)
            m, s_, t = kce.chunk_stats(logits, local, lo)
            rm, rs_, rt = kce.chunk_stats_reference(logits, local, lo)
            torch.cuda.synchronize()
            # the max and the target are exact; s is an f32 sum of exps in
            # another order (ex2.approx, a slab at a time) against the
            # plain one: 2e-5 of s, while one column left out or added
            # moves s by some 1/vc of itself
            if not (torch.equal(m, rm) and torch.equal(t, rt)):
                raise AssertionError(f"chunk_stats {dtype} lo={lo}: max or "
                                     f"target differs")
            err, worst = check_close(f"chunk_stats {dtype} lo={lo}", s_, rs_,
                                     2e-5 * rs_)
            again = kce.chunk_stats(logits, local, lo)
            if not all(torch.equal(x, y) for x, y in zip((m, s_, t), again)):
                raise AssertionError(f"chunk_stats {dtype} lo={lo}: a second "
                                     f"launch gave other bits")
            log(f"[kernels] chunk_stats N={n} vc={vc} lo={lo} {dtype}: m and "
                f"t exact, s max abs err {err:.3g} (limit 2e-5 of s, worst "
                f"err/limit {worst:.3g}); a second launch repeats it bit for "
                f"bit")
            elt = logits.element_size()
            record("chunk_stats", err, dtype, kce.chunk_stats,
                   (logits, local, lo), kce.chunk_stats_reference,
                   n * vc * elt + 16 * n, 5 * n * vc,
                   f"logits[{n},{vc}] bf16, lo 0/768")
            lse = rm + torch.log(rs_) + 0.25
            scale = torch.rand(n, device=dev, generator=gen) / n
            scale[9] = 0.0                              # an ignored row
            out = kce.chunk_dlogits(logits, lse, local, scale, lo)
            ref = kce.chunk_dlogits_reference(logits, lse, local, scale, lo)
            torch.cuda.synchronize()
            if out[:, :lo].any() or out[9].any():
                raise AssertionError(f"chunk_dlogits {dtype} lo={lo}: masked "
                                     f"columns or the ignored row not 0")
            # the same f32 formula rounded once; the exps differ in their
            # last f32 bits (1e-6 of p, times the row's scale), which may
            # flip a bf16 rounding: one ulp
            ulp = BF16_ULP if dtype == torch.bfloat16 else 1e-6
            err, worst = check_close(
                f"chunk_dlogits {dtype} lo={lo}", out, ref,
                ulp * ref.float().abs() + 1e-6 * scale[:, None] + 1e-12)
            log(f"[kernels] chunk_dlogits N={n} vc={vc} lo={lo} {dtype}: max "
                f"abs err {err:.3g} (limit {ulp:.3g} of each |ref| + 1e-6 of "
                f"the row's scale, worst err/limit {worst:.3g})")
            record("chunk_dlogits", err, dtype, kce.chunk_dlogits,
                   (logits, lse, local, scale, lo),
                   kce.chunk_dlogits_reference,
                   2 * n * vc * elt + 12 * n, 5 * n * vc,
                   f"logits[{n},{vc}] bf16, lo 0/768")
            del logits, local, m, s_, t, rm, rs_, rt, lse, scale, out, ref
    torch.cuda.empty_cache()
    return res


def flash_checks(batch, seq, nh, kvh, d, rand, wide_batch=None,
                 causal=True):
    """K7, K8 and K9 at one shape ([batch, seq] tokens, nh query and kvh
    key/value heads of width d; ``causal`` or not) against the plain
    versions, with per-element limits. ``a = sum_i p_i |v_i|`` scales a
    forward output's rounding error and ``attention_scales`` the
    gradients'. A key dropped from or added to a row of n keys moves its
    output by about a / n (4e-4 at n = 2048 for unit values); the f32
    limit, 1e-5 * a, is checked to refuse both. In bf16 the backward
    kernels are launched twice on the same inputs and must give the same
    bits (each CTA writes its rows once, no atomics), and so must the
    forward's out and lse; the times come with the rate achieved (the
    bound's operations over the time) and the bound's share of the time,
    and with ``wide_batch`` K7, K8 and K9 are also timed at that batch
    (train_full's [4, 2049]). The library times are SDPA's: its forward,
    and its backward (dq, dk and dv in one) as the device time of forward
    plus backward less the forward's, both captured in CUDA graphs."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    res = {}
    s_tok = seq
    # the (query, key) pairs attended
    pairs = s_tok * (s_tok + 1) // 2 if causal else s_tok * s_tok
    word = "causal" if causal else "non-causal"
    bh = batch * nh
    for dtype in (torch.bfloat16, torch.float32):
        q = rand(batch, s_tok, nh, d, dtype=dtype)
        k = rand(batch, s_tok, kvh, d, dtype=dtype)
        v = rand(batch, s_tok, kvh, d, dtype=dtype)
        go = rand(batch, s_tok, nh, d, dtype=dtype)
        out, lse = kfa.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = kfa.flash_attention_fwd_reference(q, k, v, causal)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v)]
        a = kfa.flash_attention_fwd_reference(f32[0], f32[1], f32[2].abs(),
                                              causal)[0]
        if dtype == torch.bfloat16:
            # both sides round each probability to bf16 before P.V (at
            # most 2^-8 * a each: bf16's unit roundoff is 2^-8) and round
            # the output (half an ulp each)
            err, worst = check_close(
                "flash fwd bf16", out, ref,
                1.01 * (2 ** -7 * a + BF16_ULP * ref.float().abs()) + 1e-6)
            ref32, _ = kfa.flash_attention_fwd_reference(*f32, causal)
            # against f32 throughout: the kernel's P rounding (2^-8 * a)
            # and its output rounding
            _, worst1 = check_close("flash fwd bf16 vs f32 plain", out,
                                    ref32, 2 ** -8 * a + BF16_ULP
                                    * ref32.abs() + 1e-5 * a + 1e-6)
            del ref32
        else:
            err, worst = check_close("flash fwd f32", out, ref,
                                     1e-5 * a + 1e-6)
            tol = 1e-5 * a + 1e-6
            # the same check must refuse a plain version whose rows each
            # lose their last key or gain one: causal, the diagonal
            # offset by -1 or +1 (rows s/2 .. s-2 only: each sees at
            # least s/2 keys); not causal, the last key left out or the
            # first key seen twice
            if causal:
                dropped = kfa.flash_attention_fwd_reference(
                    torch.cat([q, q[:, -1:]], 1), k, v, True)[0][:, :s_tok]
                extra = kfa.flash_attention_fwd_reference(
                    q[:, :s_tok - 1], k, v, True)[0]
                sl = slice(s_tok // 2, s_tok - 1)
            else:
                dropped = kfa.flash_attention_fwd_reference(
                    q, k[:, :-1], v[:, :-1], False)[0]
                extra = kfa.flash_attention_fwd_reference(
                    q, torch.cat([k, k[:, :1]], 1),
                    torch.cat([v, v[:, :1]], 1), False)[0]
                sl = slice(None)
            for name, bad in (("dropped", dropped), ("extra", extra)):
                try:
                    check_close(f"flash fwd f32 vs one key {name}",
                                out[:, sl], bad[:, sl], tol[:, sl])
                except AssertionError as e:
                    log(f"[kernels] flash fwd f32 limit refuses one key "
                        f"{name} per row: {e}")
                else:
                    raise AssertionError(f"the f32 attention limit does "
                                         f"not refuse one key {name}")
            del dropped, extra, tol
        lse_err, _ = check_close(f"flash lse {dtype}", lse, ref_lse,
                                 1e-6 * ref_lse.abs() + 1e-5)
        delta = kfa._delta(ref, go)
        bwd_args = (q, k, v, go, ref_lse, delta, causal)
        dk, dv = kfa.flash_attention_dkv(*bwd_args)
        dq = kfa.flash_attention_dq(*bwd_args)
        rk, rv = kfa.flash_attention_dkv_reference(*bwd_args)
        rq = kfa.flash_attention_dq_reference(*bwd_args)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            again = (*kfa.flash_attention_fwd(q, k, v, causal),
                     *kfa.flash_attention_dkv(*bwd_args),
                     kfa.flash_attention_dq(*bwd_args))
            for name, a1, a2 in zip(("out", "lse", "dk", "dv", "dq"),
                                    (out, lse, dk, dv, dq), again):
                if not torch.equal(a1, a2):
                    raise AssertionError(f"flash {name} bf16: a second "
                                         f"launch on the same inputs gave "
                                         f"other bits")
            del again
            log(f"[kernels] flash fwd/dkv/dq bf16 B={batch} S={s_tok} "
                f"H={nh} KVH={kvh} D={d} {word}: a second launch repeats "
                f"out, lse, dk, "
                f"dv and dq bit for bit")
        sq_, sk_, sv_ = attention_scales(*bwd_args)
        errs = {}
        for name, got, want, sc in (("dq", dq, rq, sq_), ("dk", dk, rk, sk_),
                                    ("dv", dv, rv, sv_)):
            if dtype == torch.bfloat16:
                # the kernel rounds p and ds to bf16 before their
                # products (2^-8 of the scale), each side rounds its
                # output (half an ulp each), f32 noise
                tol = (2 ** -8 + 1e-5) * sc + BF16_ULP * want.float().abs() \
                    + 1e-6
            else:
                tol = 1e-5 * sc + 1e-6      # summation order and exp only
            errs[name] = check_close(f"flash {name} {dtype}", got, want, tol)
        del sq_, sk_, sv_, rq, rk, rv, a
        log(f"[kernels] flash attention B={batch} S={s_tok} H={nh} "
            f"KVH={kvh} D={d} {word} {dtype}: fwd max abs err {err:.3g} "
            f"(worst err/limit {worst:.3g}"
            + (f"; vs f32 plain {worst1:.3g}" if dtype == torch.bfloat16
               else "") + f"), lse {lse_err:.3g}; "
            + ", ".join(f"{k_} {e[0]:.3g} (worst {e[1]:.3g})"
                        for k_, e in errs.items()))
        if dtype == torch.float32:
            res["flash_attention_fwd"]["max_abs_err_f32"] = err
            res["flash_attention_dkv"]["max_abs_err_f32"] = max(
                errs["dk"][0], errs["dv"][0])
            res["flash_attention_dq"]["max_abs_err_f32"] = errs["dq"][0]
            del q, k, v, go, out, lse, ref, ref_lse, delta, dq, dk, dv
            del bwd_args
            torch.cuda.empty_cache()
            continue
        # bf16: times at the training shape
        elt = 2
        qb = batch * s_tok * nh * d * elt        # q, out, dO, dq bytes
        kb = batch * s_tok * kvh * d * elt       # k, v, dk, dv bytes
        sb = bh * s_tok * 4                      # lse or delta bytes
        fwd_args = (q, k, v, causal)
        ms = time_ms(kfa.flash_attention_fwd, fwd_args, iters=5)
        plain = time_ms(kfa.flash_attention_fwd_reference, fwd_args,
                        iters=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qt, kt, vt):
            return tF.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal,
                                                   enable_gqa=True)
        lib = time_ms(sdpa, (qt, kt, vt), iters=5)
        b_ms, b_by = bound(2 * qb + 2 * kb + sb, 4 * d * pairs * bh,
                           PEAK_BF16)
        shape = (f"q[{batch},{s_tok},{nh},{d}] kv[{batch},{s_tok},{kvh},"
                 f"{d}] bf16 {word}")
        res["flash_attention_fwd"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=b_ms, bound_by=b_by, shape=shape)
        ms_kv = time_ms(kfa.flash_attention_dkv, bwd_args, iters=5)
        ms_q = time_ms(kfa.flash_attention_dq, bwd_args, iters=5)
        plain_kv = time_ms(kfa.flash_attention_dkv_reference, bwd_args,
                           iters=2)
        plain_q = time_ms(kfa.flash_attention_dq_reference, bwd_args,
                          iters=2)
        gt = go.transpose(1, 2)

        def sdpa_fwd_bwd(*qkv_g):
            # leaves made inside the captured call: autograd syncs with
            # the streams its leaves were made on, which must be the
            # capturing one
            qkv = [t.detach().requires_grad_() for t in qkv_g[:3]]
            return torch.autograd.grad(sdpa(*qkv), qkv, qkv_g[3])
        # SDPA's backward computes dq, dk and dv in one: K8 + K9 together;
        # its device time is that of forward plus backward less the
        # forward's, each from a CUDA graph
        lib_fb = time_ms(sdpa_fwd_bwd, (qt, kt, vt, gt), iters=5)
        lib_bwd = float(lib_fb) - float(lib)
        kv_ms, kv_by = bound(2 * qb + 2 * kb + 2 * sb + 2 * kb,
                             8 * d * pairs * bh, PEAK_BF16)
        q_ms, q_by = bound(2 * qb + 2 * kb + 2 * sb + qb,
                           6 * d * pairs * bh, PEAK_BF16)
        res["flash_attention_dkv"] = dict(
            max_abs_err=max(errs["dk"][0], errs["dv"][0]), ms=ms_kv,
            plain_ms=plain_kv, library_ms=lib_bwd, bound_ms=kv_ms,
            bound_by=kv_by, shape=res["flash_attention_fwd"]["shape"])
        res["flash_attention_dq"] = dict(
            max_abs_err=errs["dq"][0], ms=ms_q, plain_ms=plain_q,
            library_ms=lib_bwd, bound_ms=q_ms, bound_by=q_by,
            shape=res["flash_attention_fwd"]["shape"])
        for name in ("flash_attention_fwd", "flash_attention_dkv",
                     "flash_attention_dq"):
            res[name]["design"] = WGMMA_DESIGN
        log(f"[kernels] flash_attention_fwd at {shape}: kernel {ms:.4f} ms "
            f"plain {plain:.4f} ms SDPA {lib:.4f} ms bound {b_ms:.4f} ms "
            f"({b_by}); {_rate(4 * d * pairs * bh, ms, b_ms)}")
        log(f"[kernels] flash_attention_dkv: kernel {ms_kv:.4f} ms plain "
            f"{plain_kv:.4f} ms bound {kv_ms:.4f} ms ({kv_by}); "
            f"{_rate(8 * d * pairs * bh, ms_kv, kv_ms)}; "
            f"flash_attention_dq: kernel {ms_q:.4f} ms plain {plain_q:.4f} "
            f"ms bound {q_ms:.4f} ms ({q_by}); "
            f"{_rate(6 * d * pairs * bh, ms_q, q_ms)}; SDPA backward (dq, "
            f"dk, dv together; fwd+bwd {lib_fb:.4f} - fwd {lib:.4f}, "
            f"device times) {lib_bwd:.4f} ms; K8 + K9 "
            f"{float(ms_kv) + float(ms_q):.4f} ms")
        del q, k, v, go, out, lse, ref, ref_lse, delta, dq, dk, dv
        del qt, kt, vt, gt, bwd_args
        torch.cuda.empty_cache()
        if wide_batch:
            for name, wide in zip(("flash_attention_fwd",
                                   "flash_attention_dkv",
                                   "flash_attention_dq"),
                                  _flash_wide(wide_batch, s_tok, nh, kvh, d,
                                              rand)):
                res[name]["wide"] = wide
    return res


def _rate(ops, ms, b_ms):
    """The rate a kernel achieved and the share of its time the bound
    is, as a log fragment."""
    return (f"{ops / (float(ms) * 1e-3) / 1e12:.1f} TFLOP/s, bound "
            f"{b_ms / float(ms):.1%} of the time")


def _flash_wide(batch, s_tok, nh, kvh, d, rand):
    """K7, K8 and K9 timed at a wider batch (causal, bf16), each beside its
    bound, K7 also beside SDPA; the backward's lse and delta come from the
    forward kernel."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    q = rand(batch, s_tok, nh, d)
    k, v = rand(batch, s_tok, kvh, d), rand(batch, s_tok, kvh, d)
    go = rand(batch, s_tok, nh, d)
    out, lse = kfa.flash_attention_fwd(q, k, v, True)
    delta = kfa._delta(out, go)
    args = (q, k, v, go, lse, delta, True)
    pairs = s_tok * (s_tok + 1) // 2 * batch * nh
    qb, kb = q.numel() * 2, k.numel() * 2
    sb = batch * nh * s_tok * 4
    shape = (f"q[{batch},{s_tok},{nh},{d}] kv[{batch},{s_tok},{kvh},{d}] "
             f"bf16 causal")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = time_ms(lambda a, b, c: tF.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=True), (qt, kt, vt), iters=5)
    out_ = []
    for name, fn, fargs, ops, n_bytes in (
            ("fwd", kfa.flash_attention_fwd, (q, k, v, True), 4 * d * pairs,
             2 * qb + 2 * kb + sb),
            ("dkv", kfa.flash_attention_dkv, args, 8 * d * pairs,
             2 * qb + 2 * kb + 2 * sb + 2 * kb),
            ("dq", kfa.flash_attention_dq, args, 6 * d * pairs,
             2 * qb + 2 * kb + 2 * sb + qb)):
        ms = time_ms(fn, fargs, iters=5)
        b_ms, b_by = bound(n_bytes, ops, PEAK_BF16)
        lib = sdpa if name == "fwd" else None
        log(f"[kernels] flash_attention_{name} at {shape}: kernel "
            f"{ms:.4f} ms bound {b_ms:.4f} ms ({b_by}); "
            f"{_rate(ops, ms, b_ms)}"
            + (f"; SDPA {lib:.4f} ms" if lib is not None else ""))
        out_.append(dict(ms=ms, bound_ms=b_ms, bound_by=b_by, shape=shape,
                         tflops=ops / (float(ms) * 1e-3) / 1e12,
                         **({"library_ms": lib} if lib is not None
                            else {})))
    del q, k, v, go, out, lse, delta, args, qt, kt, vt
    torch.cuda.empty_cache()
    return out_


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


def _serve_traffic(vocab):
    """The serve phase's traffic: a 16-token warm-up request (4 new), then
    12 prompts of 64-1500 tokens, from one seeded generator."""
    rng = np.random.RandomState(42)
    warm = rng.randint(0, vocab, 16)
    prompt_lens = rng.permutation(np.linspace(64, 1500, 12).astype(int))
    return warm, [rng.randint(0, vocab, int(n)) for n in prompt_lens]


def serve_model(cfg, dev="cuda", dtype=None):
    """Llama-3-8B at full width and ``cfg``'s depth, seeded random weights
    (seed 0)."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=dtype or torch.bfloat16,
                             seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] Llama-3-8B {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.2f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def _serial(eng):
    """Drive ``eng`` with serial ``step()`` turns (admit, dispatch,
    harvest, drain) until it holds no work; returns the completions."""
    done = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        done += eng.step()
    return done


def phase_serve(cfg, model, dev="cuda", kv_quant="none"):
    """Llama-3-8B at full width (serve's depth) through the engine, with
    bf16 pools (phase serve) or int8/fp8 ones (phase serve_quant), the
    prefix cache off. Serve runs its traffic twice on one engine: through
    the pipelined ``run()`` (launches counted) and through serial
    ``step()`` turns; the greedy streams must agree token for token."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    tag = "serve" if kv_quant == "none" else f"serve_quant {kv_quant}"
    attn = "ragged_paged_attention" + ("" if kv_quant == "none"
                                       else "_quant")
    eng = ContinuousBatchingEngine(model, num_slots=8, page_size=16,
                                   max_len=2048, prefill_chunk=256,
                                   decode_chunk=8, kv_quant=kv_quant,
                                   prefix_cache=False, audit=True,
                                   device=dev)
    pool_gb = sum(p.numel() * p.element_size() for p in eng.pools) / 1e9
    g = eng.gauges()
    log(f"[{tag}] KV pool {pool_gb:.3f} GB ({eng.num_pages} pages; "
        f"{g['kv_quant_pool_bytes'] / 1e9:.3f} GB of {g['kv_quant_bits']}-"
        f"bit codes, {g['kv_quant_scale_pool_bytes'] / 1e6:.1f} MB of "
        f"scales)")
    warm, prompts = _serve_traffic(model.config.vocab_size)
    # warm-up (cuBLAS handles, allocator) outside the counted run
    eng.add_request(warm, 4)
    eng.run()
    eng.reset_gauges()
    n_new = 32
    ids = [eng.add_request(p, n_new) for p in prompts]
    names = ("rms_norm", "swiglu", attn)
    fw0 = eng._stats["forwards"]
    torch.cuda.reset_peak_memory_stats()
    wrappers = _counted(names)
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = eng._stats["forwards"] - fw0
    gp = eng.gauges()
    if len(done) != 12:
        raise AssertionError(f"{len(done)} of 12 requests completed")
    bad = [(r.request_id, len(r.tokens)) for r in done
           if len(r.tokens) != n_new or r.finish_reason != "length"]
    if bad:
        raise AssertionError(f"requests without {n_new} tokens: {bad}")
    if len(eng._free_pages) != eng.num_pages - 1:
        raise AssertionError(f"free list {len(eng._free_pages)} of "
                             f"{eng.num_pages - 1} pages after the run")
    L = model.config.num_hidden_layers
    want = {"rms_norm": (2 * L + 1) * forwards, "swiglu": L * forwards,
            attn: L * forwards}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for "
                             f"{forwards} forwards")
    peak = torch.cuda.max_memory_allocated() / 1e9
    prompt_lens = sorted(len(p) for p in prompts)
    log(f"[{tag}] 12 requests (prompts {prompt_lens}, "
        f"{n_new} new each) in {wall:.2f} s through run(): "
        f"{12 * n_new / wall:.1f} generated tok/s, {gp['unified_steps']} "
        f"steps, {forwards} forwards, prefill_overlap_frac "
        f"{gp['prefill_overlap_frac']:.3f}, peak memory {peak:.2f} GB")
    log(f"[{tag}] launches {launches} (per forward: {2 * L + 1} rms_norm, "
        f"{L} swiglu, {L} attention)")
    by = {r.request_id: r.tokens for r in done}
    streams = [by[i] for i in ids]
    res = dict(launches=launches, streams=streams, wall_s=wall,
               tok_s=12 * n_new / wall, peak_gb=peak, pool_gb=pool_gb,
               forwards=forwards,
               overlap=gp["prefill_overlap_frac"],
               profile=_profile_two_requests(tag, eng,
                                             model.config.vocab_size))
    if kv_quant == "none":
        # the same traffic through serial step() turns on the same engine
        eng.reset_gauges()
        ids = [eng.add_request(p, n_new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = _serial(eng)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        by = {r.request_id: r.tokens for r in done}
        serial = [by[i] for i in ids]
        if serial != streams:
            diff = [i for i, (a, b) in enumerate(zip(serial, streams))
                    if a != b]
            raise AssertionError(f"[serve] serial step() streams differ "
                                 f"from run()'s at requests {diff}")
        gs = eng.gauges()
        log(f"[serve] the same 12 requests through serial step(): "
            f"{wall_s:.2f} s, {12 * n_new / wall_s:.1f} generated tok/s, "
            f"{gs['unified_steps']} steps, prefill_overlap_frac "
            f"{gs['prefill_overlap_frac']:.3f}; greedy streams identical "
            f"to run()'s")
        res["serial"] = dict(
            wall_s=wall_s, tok_s=12 * n_new / wall_s,
            overlap=gs["prefill_overlap_frac"],
            profile=_profile_two_requests("serve serial", eng,
                                          model.config.vocab_size,
                                          serial=True))
    del eng
    torch.cuda.empty_cache()
    return res


def _profile_two_requests(tag, eng, vocab, seed=43, serial=False):
    """Two more requests (700 and 300 prompt tokens, 16 new) through the
    engine (``run()``, or serial ``step()`` turns) under torch.profiler:
    the device time by layer, K12/K13's share of it and the attention
    kernels' device symbols."""
    rng = np.random.RandomState(seed)

    def two_requests():
        for n in (700, 300):
            eng.add_request(rng.randint(0, vocab, n), 16)
        if serial:
            _serial(eng)
        else:
            eng.run()
    prof = _profile(tag, two_requests)
    if prof:
        cat = "paged attention K12/K13/K16"
        ms = prof["by_layer"].get(cat, 0.0)
        log(f"[{tag}] K12/K13 {ms:.2f} ms of {prof['busy_ms']:.1f} ms of "
            f"device time ({100 * ms / prof['busy_ms']:.1f}%)")
    return prof


def _agreement(a, b):
    """Greedy top-1 agreement of two sets of streams, position by position
    (the JAX bench's measure, ``tests/test_quant_serving.py``)."""
    num = den = 0
    for x, y in zip(a, b):
        den += max(len(x), len(y))
        num += sum(1 for u, w in zip(x, y) if u == w)
    return num / max(den, 1)


def _fresh_pools(model, n_tokens, kv_quant="none", page=16):
    """One slot's paged pools for ``n_tokens`` (page 0 the trash page), in
    the engine's layout: 2 pools a layer, 4 with the scales of int8/fp8
    codes. Returns (pools, block-table row [1, pages])."""
    import torch
    cfg = model.config
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    pages = -(-n_tokens // page)
    shape = (cfg.num_key_value_heads, pages + 1, page, cfg.head_dim)
    code = dtype if kv_quant == "none" else _pool_dtype(kv_quant)
    layer = [(shape, code)] * 2
    if kv_quant != "none":
        layer += [(shape[:3], torch.float32)] * 2
    pools = [torch.zeros(s, dtype=dt, device=dev)
             for _ in range(cfg.num_hidden_layers) for s, dt in layer]
    tables = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    return pools, tables


def _prefill_logits(model, tokens, kv_quant="none", chunk=None):
    """Logits [S, V] of one prefill of ``tokens`` through fresh pools (one
    slot): in one chunk, or in chunks of ``chunk`` tokens."""
    import torch
    dev = next(model.parameters()).device
    pools, tables = _fresh_pools(model, len(tokens), kv_quant)
    chunk = chunk or len(tokens)
    out = []
    for start in range(0, len(tokens), chunk):
        part = list(tokens[start:start + chunk])
        logits, _ = model(
            torch.tensor([part], device=dev), caches=pools,
            pos=torch.tensor([start], dtype=torch.int32, device=dev),
            tables=(tables, torch.tensor([len(part)], device=dev)))
        out.append(logits[0])
    del pools
    return torch.cat(out)


def _top2_gap(model, tokens, kv_quant="none"):
    """Top-2 logit gap of the next token after ``tokens`` (one slot,
    fresh pools, int8/fp8 ones for ``kv_quant``), on the model's own
    device."""
    import torch
    logits = _prefill_logits(model, tokens, kv_quant)
    top = torch.topk(logits[-1].float(), 2).values
    return float(top[0] - top[1])


#: |GPU - CPU| of a ``generate`` score (the mean f32 logprob of 16
#: tokens, about -12 at the init's logits) at depth 2 in f32
GEN_SCORE_TOL = 1e-3
#: phase parity's new tokens a request, cut for the script's time limit
#: (the CPU legs take most of the phase's time)
PARITY_NEW = 8


def _hold_streams(tag, what, gpu, cpu, cpu_model, prompts, kv_quant):
    """GPU streams against CPU ones, token for token; a divergence is
    allowed only on a near tie (the CPU's top-2 gap at that token under
    1e-3). Returns the indices of the identical streams."""
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        if g == c:
            continue
        j = next(k for k, (a, b) in enumerate(zip(g, c)) if a != b)
        gap = _top2_gap(cpu_model, list(prompts[i]) + c[:j], kv_quant)
        if gap >= 1e-3:
            raise AssertionError(
                f"[{tag}] {what} request {i}: GPU and CPU streams diverge "
                f"at token {j} with a CPU top-2 gap of {gap:.3g}: {g} vs {c}")
        log(f"[{tag}] {what} request {i} diverges at token {j} on a near "
            f"tie (CPU top-2 gap {gap:.3g} < 1e-3)")
    same = [i for i, (g, c) in enumerate(zip(gpu, cpu)) if g == c]
    log(f"[{tag}] {what}: {len(gpu)} greedy streams of "
        f"{len(gpu[0])} tokens: cuda vs cpu {len(same)}/{len(gpu)} identical")
    return same


def phase_parity(cfg, dev="cuda", kv_quant="none", models=None):
    """Depth 2, f32: greedy streams on the GPU and on the CPU, with f32
    pools (phase parity) or int8/fp8 ones (phase quant_parity), through
    the unified engine and the legacy one (``unified=False``); with f32
    pools also ``generate`` of each prompt alone (tokens, and scores
    within ``GEN_SCORE_TOL``), and, on the card, whether both engines'
    streams equal ``generate``'s. ``models``: the (cpu, card) pair an
    earlier call returned, so that quant_parity need not build its own;
    returns the pair."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM
    tag = "parity" if kv_quant == "none" else f"quant_parity {kv_quant}"
    torch.set_num_threads(os.cpu_count() or 1)
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    if models is None:
        t0 = time.perf_counter()
        gpu_model = LlamaForCausalLM(cfg2, device=dev, seed=5)
        cpu_model = _twin(gpu_model, "cpu")
        log(f"[{tag}] depth-2 f32 models built in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        cpu_model, gpu_model = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (128, 77, 31, 100)]
    streams = {}
    for engine in ("unified", "legacy"):
        for name, model in ((dev, gpu_model), ("cpu", cpu_model)):
            eng = ContinuousBatchingEngine(
                model, num_slots=4, page_size=16, max_len=256,
                prefill_chunk=128, decode_chunk=4, kv_quant=kv_quant,
                unified=engine == "unified", device=name)
            for p in prompts:
                eng.add_request(p, PARITY_NEW)
            t0 = time.perf_counter()
            done = sorted(eng.run(), key=lambda r: r.request_id)
            streams[engine, name] = [r.tokens for r in done]
            log(f"[{tag}] {engine} engine on {name}: "
                f"{time.perf_counter() - t0:.1f} s")
        _hold_streams(tag, f"{engine} engine", streams[engine, dev],
                      streams[engine, "cpu"], cpu_model, prompts, kv_quant)
    if kv_quant == "none":
        scores = {}
        for name, model in ((dev, gpu_model), ("cpu", cpu_model)):
            t0 = time.perf_counter()
            outs = [model.generate(torch.tensor(p[None], device=name),
                                   max_new_tokens=PARITY_NEW,
                                   decode_strategy="greedy_search")
                    for p in prompts]
            streams["generate", name] = [o[0].tolist() for o, _ in outs]
            scores[name] = [float(sc[0]) for _, sc in outs]
            log(f"[{tag}] generate on {name}: "
                f"{time.perf_counter() - t0:.1f} s")
        same = _hold_streams(tag, "generate", streams["generate", dev],
                             streams["generate", "cpu"], cpu_model, prompts,
                             kv_quant)
        err = max((abs(scores[dev][i] - scores["cpu"][i]) for i in same),
                  default=0.0)
        if err > GEN_SCORE_TOL:
            raise AssertionError(f"[{tag}] generate scores differ by "
                                 f"{err:.3g} > {GEN_SCORE_TOL}: {scores}")
        ref = streams["generate", dev]
        eq = {e: sum(a == b for a, b in zip(streams[e, dev], ref))
              for e in ("unified", "legacy")}
        log(f"[{tag}] generate scores: max |cuda - cpu| {err:.3g} over the "
            f"identical streams (limit {GEN_SCORE_TOL}); on the card, engine "
            f"streams equal to generate's: unified {eq['unified']}/4, "
            f"legacy {eq['legacy']}/4")
    return cpu_model, gpu_model


QUANT_MODES = ("int8", "fp8")


def _mixed_tables(B, P, mp, page, ctx, lengths, seed):
    """Block tables of the mixed batch: a permutation of the pages, each
    row's padding pointing at the trash page 0."""
    tables = (np.random.RandomState(seed).permutation(P - 1) + 1).reshape(
        B, mp).astype(np.int32)
    for b in range(B):
        tables[b, -(-(int(ctx[b]) + int(lengths[b])) // page):] = 0
    return tables


def phase_quant_kernels(cfg, head_cfg, dev="cuda"):
    """K13 over int8 and fp8 pools at K12's mixed batch (Llama-3-8B's
    32/8 heads, and Qwen2's 28/4, rep 7) and at serve_quant's decode step
    (one token a slot), and K16 at decode shapes, each against its plain
    version per element, in bf16 and f32."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as kpa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    # ---- K13: the serve phase's mixed batch over quantized pools
    B, C, page, max_len = 8, 256, 16, 2048
    mp = max_len // page
    P = B * mp + 1
    lengths = np.array([0, 1, 1, 17, 256, 256, 1, 100], np.int32)
    ctx = np.array([0, 1800, 700, 300, 0, 1000, 1200, 33], np.int32)
    d = cfg.head_dim
    kv_keys = int(np.sum((ctx + lengths)[lengths > 0]))
    pairs = sum(int(ctx[b]) * int(lengths[b])
                + int(lengths[b]) * (int(lengths[b]) + 1) // 2
                for b in range(B))
    r = res["ragged_paged_attention_quant"] = {"max_abs_err": 0.0,
                                               "max_abs_err_f32": 0.0}
    for heads, (nh, kvh), seed in (("llama", (cfg.num_attention_heads,
                                              cfg.num_key_value_heads), 11),
                                   ("qwen2", (head_cfg.num_attention_heads,
                                              head_cfg.num_key_value_heads),
                                    12)):
        tb, ct, ln = (torch.from_numpy(a).to(dev) for a in (
            _mixed_tables(B, P, mp, page, ctx, lengths, seed), ctx,
            lengths))
        kf, vf = rand(kvh, P, page, d, dtype=f32), rand(kvh, P, page, d,
                                                          dtype=f32)
        q16 = rand(B, C, nh, d)
        for mode in QUANT_MODES:
            kc, ks = PA.quantize_kv(kf, _pool_dtype(mode))
            vc, vs = PA.quantize_kv(vf, _pool_dtype(mode))
            # the trash page: non-finite scales (and fp8 NaN codes)
            ks[:, 0] = vs[:, 0] = float("nan")
            if mode == "fp8":
                kc.view(torch.uint8)[:, 0] = 0x7F
                vc.view(torch.uint8)[:, 0] = 0x7F
            # a = sum_i p_i |v_i| over the dequantized values scales an
            # output's error
            a = krpa.ragged_paged_attention_reference(
                q16.float(), PA.dequantize_pages(kc, ks),
                PA.dequantize_pages(vc, vs).abs(), tb, ct, ln).float()
            for q in (q16, q16.float()):
                args = (q, kc, vc, ks, vs, tb, ct, ln)
                out = krpa.ragged_paged_attention_quant(*args)
                ref = _k13_plain(*args)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all() or any(
                        out[b, lengths[b]:].any() for b in range(B)):
                    raise AssertionError(
                        f"K13 {heads} {mode}: non-finite output or rows "
                        f"past a slot's length not zero")
                # both sides dequantize the same codes to the same f32
                # values and keep f32 probabilities: summation order and
                # exp (1e-5 * a), and for a bf16 q one rounding of each
                # output (one ulp of |ref|)
                ulp = BF16_ULP if q.dtype == bf16 else 0.0
                err, worst = check_close(
                    f"K13 {heads} {mode} {q.dtype}", out, ref,
                    1e-5 * a + ulp * ref.float().abs() + 1e-6)
                key = "max_abs_err" if q.dtype == bf16 else "max_abs_err_f32"
                r[key] = max(r[key], err)
                log(f"[quant_kernels] ragged_paged_attention_quant {heads} "
                    f"H={nh} KVH={kvh} {mode} pools, q {q.dtype}: max abs "
                    f"err {err:.3g} (limit 1e-5*sum p|v| + "
                    f"{'1 ulp of |ref|' if ulp else '0'} + 1e-6, worst "
                    f"err/limit {worst:.3g})")
            if heads != "llama":
                continue
            args = (q16, kc, vc, ks, vs, tb, ct, ln)
            if not torch.equal(krpa.ragged_paged_attention_quant(*args),
                               krpa.ragged_paged_attention_quant(*args)):
                raise AssertionError(f"K13 {mode}: two launches on the same "
                                     f"inputs gave other bits")
            ms = time_ms(krpa.ragged_paged_attention_quant, args)
            eager = eager_ms(krpa.ragged_paged_attention_quant, args)
            plain = time_ms(_k13_plain, args, iters=2)
            n_bytes = (int(lengths.sum()) * nh * d * 2 + B * C * nh * d * 2
                       + 2 * kv_keys * kvh * (d + 4))
            b_ms, b_by = bound(n_bytes, 4 * d * nh * pairs, PEAK_BF16)
            log(f"[quant_kernels] ragged_paged_attention_quant {mode} q "
                f"[{B},{C},{nh},{d}] bf16 lengths={lengths.tolist()} "
                f"ctx={ctx.tolist()}: kernel {ms:.4f} ms (eager "
                f"{eager:.4f}) plain {plain:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
            entry = dict(ms=ms, eager_ms=eager, plain_ms=plain,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         design=RAGGED_DESIGN,
                         shape=f"q[{B},{C},{nh},{d}] bf16, {mode} pools"
                               f"[{kvh},{P},{page},{d}] + f32 scales")
            if mode == "int8":
                r.update(entry)
            else:
                r["fp8"] = entry
        del kf, vf, q16, kc, vc, ks, vs, a, out, ref
        torch.cuda.empty_cache()

    # ---- K13 at serve_quant's decode forward (7 of every 8 it runs): one
    # token in each of 8 slots, contexts 64-2048 (ctx - 1 cached), the
    # split plan that step runs
    nh, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    P = B * mp + 1
    ctx1 = np.linspace(64, max_len, B).astype(np.int32) - 1
    ones = np.ones(B, np.int32)
    tb, ct, ln = (torch.from_numpy(a).to(dev) for a in (
        _mixed_tables(B, P, mp, page, ctx1, ones, 14), ctx1, ones))
    kf, vf = rand(kvh, P, page, d, dtype=f32), rand(kvh, P, page, d,
                                                      dtype=f32)
    q16 = rand(B, 1, nh, d)
    plan = krpa.split_plan(B, 1, kvh, nh // kvh, d, mp * page)
    for mode in QUANT_MODES:
        kc, ks = PA.quantize_kv(kf, _pool_dtype(mode))
        vc, vs = PA.quantize_kv(vf, _pool_dtype(mode))
        ks[:, 0] = vs[:, 0] = float("nan")
        if mode == "fp8":
            kc.view(torch.uint8)[:, 0] = 0x7F
            vc.view(torch.uint8)[:, 0] = 0x7F
        a = krpa.ragged_paged_attention_reference(
            q16.float(), PA.dequantize_pages(kc, ks),
            PA.dequantize_pages(vc, vs).abs(), tb, ct, ln).float()
        args = (q16, kc, vc, ks, vs, tb, ct, ln)
        out = krpa.ragged_paged_attention_quant(*args)
        ref = _k13_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"K13 {mode} at lengths 1: non-finite "
                                 f"output (the trash page reached a row)")
        # the mixed batch's limit
        err, worst = check_close(
            f"K13 {mode} at lengths 1", out, ref,
            1e-5 * a + BF16_ULP * ref.float().abs() + 1e-6)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if not torch.equal(krpa.ragged_paged_attention_quant(*args), out):
            raise AssertionError(f"K13 {mode} at lengths 1: a second launch "
                                 f"gave other bits")
        ms = time_ms(krpa.ragged_paged_attention_quant, args)
        (r if mode == "int8" else r["fp8"])["decode_ms"] = ms
        log(f"[quant_kernels] ragged_paged_attention_quant {mode} at "
            f"lengths 1, q [{B},1,{nh},{d}] bf16, ctx {ctx1.min() + 1}-"
            f"{ctx1.max() + 1}: split plan {plan}; max abs err {err:.3g} "
            f"(limit 1e-5*sum p|v| + 1 ulp of |ref| + 1e-6, worst err/limit "
            f"{worst:.3g}); a second launch repeats it bit for bit; kernel "
            f"{ms:.4f} ms")
    del kf, vf, q16, kc, vc, ks, vs, a, out, ref, args
    torch.cuda.empty_cache()
    # ---- K13 at the spec phase's verification step
    r["verify"] = k13_verify_shape(cfg, rand, dev)

    # ---- K16: decode shapes (one query token a sequence)
    r = res["paged_attention"] = {"max_abs_err": 0.0,
                                  "max_abs_err_f32": 0.0}
    for line in _ptxas_summary(_build.build_log()):
        if "paged_split" in line or "paged_decode" in line:
            log(f"[quant_kernels] K16 {line}")
    for B in (8, 64):
        ctx = np.linspace(64, max_len, B).astype(np.int32)
        P = B * mp + 1
        tb, ct = (torch.from_numpy(a).to(dev) for a in (
            _mixed_tables(B, P, mp, page, ctx, np.zeros(B, np.int32), 13),
            ctx))
        kp, vp = rand(kvh, P, page, d), rand(kvh, P, page, d)
        kp[:, 0] = vp[:, 0] = float("nan")
        q = rand(B, nh, d)
        f32s = [t.float() for t in (q, kp, vp)]
        a = kpa.paged_attention_reference(f32s[0], f32s[1], f32s[2].abs(),
                                          tb, ct).float()
        ref32 = kpa.paged_attention_reference(*f32s, tb, ct)
        for dt in (bf16, f32):
            args = (q, kp, vp, tb, ct) if dt == bf16 else (*f32s, tb, ct)
            out = kpa.paged_attention(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError("K16: non-finite output (the NaN trash "
                                     "page reached a row)")
            if dt == bf16:
                # the plain version rounds each probability to bf16 before
                # P.V (2^-8 * a at most); each side rounds its output
                ref = kpa.paged_attention_reference(*args)
                err, worst = check_close(
                    f"K16 B={B} bf16", out, ref, 1.01 * (
                        2 ** -8 * a + BF16_ULP * ref.float().abs()) + 1e-6)
                # against the f32 plain version: one rounding of the output
                _, worst1 = check_close(
                    f"K16 B={B} bf16 vs f32 plain", out, ref32,
                    BF16_ULP * ref32.abs() + 1e-5 * a + 1e-6)
                r["max_abs_err"] = max(r["max_abs_err"], err)
            else:
                err32, worst32 = check_close(f"K16 B={B} f32", out, ref32,
                                             1e-5 * a + 1e-6)
                r["max_abs_err_f32"] = max(r["max_abs_err_f32"], err32)
        args = (q, kp, vp, tb, ct)
        ms = time_ms(kpa.paged_attention, args)
        eager = eager_ms(kpa.paged_attention, args)
        plain = time_ms(kpa.paged_attention_reference, args, iters=2)
        # K12 on the same function: one token a slot, ctx - 1 cached (the
        # engine's decode forward; its keys split over CTAs)
        rag = (q[:, None].contiguous(), kp, vp, tb, ct - 1,
               torch.ones(B, dtype=torch.int32, device=dev))
        rag_out = krpa.ragged_paged_attention(*rag)
        # both keep f32 probabilities and round their outputs once
        check_close(f"K12 at lengths 1 vs K16, B={B}", rag_out[:, 0],
                    kpa.paged_attention(*args),
                    2 * BF16_ULP * ref32.abs() + 1e-5 * a + 1e-6)
        _, rw, rw1, _, rw32 = ragged_checks(
            krpa, rag, krpa.ragged_paged_attention_reference(*rag), rag_out)
        if not torch.equal(krpa.ragged_paged_attention(*rag), rag_out):
            raise AssertionError(f"K12 at lengths 1, B={B}: a second launch "
                                 f"gave other bits")
        if not torch.equal(kpa.paged_attention(*args), kpa.paged_attention(
                *args)):
            raise AssertionError(f"K16 B={B}: a second launch gave other "
                                 f"bits")
        k16_plan = kpa.decode_split_plan(B, kvh, nh // kvh, d,
                                         tb.shape[1] * page)
        plan = krpa.split_plan(B, 1, kvh, nh // kvh, d, tb.shape[1] * page)
        log(f"[quant_kernels] K12 at lengths 1, B={B}: split plan {plan}; "
            f"worst err/limit against its plain version {rw:.3g} (bf16), "
            f"{rw1:.3g} (f32 plain), {rw32:.3g} (f32 kernel); a second "
            f"launch repeats it bit for bit")
        rag_ms = time_ms(krpa.ragged_paged_attention, rag)
        keys = int(ctx.sum())
        b_ms, b_by = bound(2 * B * nh * d * 2 + 2 * keys * kvh * d * 2
                           + B * (mp + 1) * 4, 4 * d * nh * keys, PEAK_BF16)
        log(f"[quant_kernels] paged_attention B={B} H={nh} KVH={kvh} D={d} "
            f"page {page} ctx {ctx.min()}-{ctx.max()} ({keys} keys): split "
            f"plan {k16_plan} ({k16_plan[0] * B * kvh} CTAs, clusters of "
            f"{k16_plan[0]}); bf16 max abs err {err:.3g} (limit "
            f"2^-8*sum p|v| + 1 ulp of each |ref|, worst err/limit "
            f"{worst:.3g}; against the f32 plain version, limit 1 ulp, "
            f"worst {worst1:.3g}); a second launch repeats it bit for bit; "
            f"f32 max abs err {err32:.3g} (limit 1e-5*sum p|v| + 1e-6, "
            f"worst {worst32:.3g}) kernel {ms:.4f} ms (eager {eager:.4f}) "
            f"plain {plain:.4f} ms K12 at lengths 1 {rag_ms:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of the time; "
            f"K12 {100 * b_ms / rag_ms:.1f}%)")
        entry = dict(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=None,
                     bound_ms=b_ms, bound_by=b_by, k12_at_decode_ms=rag_ms,
                     split_plan=list(k16_plan), design=DECODE_DESIGN,
                     shape=f"q[{B},{nh},{d}] pools[{kvh},{P},{page},{d}] "
                           f"bf16, ctx {ctx.min()}-{ctx.max()}")
        if B == 8:
            r.update(entry)
        else:
            r["b64"] = entry
        del kp, vp, q, f32s, a, ref32, out, args, rag
        torch.cuda.empty_cache()
    return res


def _pool_dtype(mode):
    import torch
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]


def _k13_plain(q, kc, vc, ks, vs, tables, ctx, lengths):
    """K13's plain version in the kernel wrapper's argument order."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    return krpa.ragged_paged_attention_reference(
        q, kc, vc, tables, ctx, lengths, k_scales=ks, v_scales=vs)


def phase_decode(cfg, batch=8, steps=8, dev="cuda"):
    """The decode paged-attention entry point (K16) as a user drives it:
    ``incubate.nn.functional.block_multihead_attention`` at Llama-3-8B's
    head layout over every layer's paged pools (32 layers), ``batch``
    sequences with cached contexts of 64-2048 tokens, ``steps`` decode
    steps, each writing its token's k/v (``paged_prefill_write``) and
    attending with int64 tables and lengths (Paddle's int dtype)."""
    import torch
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops.kernels import paged_attention as kpa
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(77)
    L, nh, kvh, d = (cfg.num_hidden_layers, cfg.num_attention_heads,
                     cfg.num_key_value_heads, cfg.head_dim)
    page, mp = 16, 2048 // 16 + 1
    P = batch * mp + 1
    ctx0 = np.linspace(64, 2048, batch).astype(np.int64)
    tables = (np.random.RandomState(14).permutation(P - 1) + 1).reshape(
        batch, mp)
    tb = torch.from_numpy(tables).to(dev)                 # int64
    pools = [torch.randn(kvh, P, page, d, device=dev,
                         generator=gen).to(torch.bfloat16)
             for _ in range(2 * L)]
    qs = [torch.randn(batch, nh, d, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(L)]
    new_kv = torch.randn(batch, 1, kvh, d, device=dev, generator=gen).to(
        torch.bfloat16)
    one = torch.ones(batch, dtype=torch.int32, device=dev)
    kpa.paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        ctx = torch.from_numpy(ctx0 + step).to(dev)       # int64
        for i in range(L):
            kp, vp = pools[2 * i], pools[2 * i + 1]
            PA.paged_prefill_write(kp, vp, new_kv, new_kv, tb, ctx, one)
            out = IF.block_multihead_attention(qs[i], kp, vp, tb, ctx + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": kpa.paged_attention.launches}
    if launches["paged_attention"] != L * steps:
        raise AssertionError(f"K16 launches {launches} != {L * steps}")
    last = (qs[-1], pools[-2], pools[-1], tb.int(), (ctx + 1).int())
    ref = kpa.paged_attention_reference(*last)
    a = kpa.paged_attention_reference(last[0].float(), last[1].float(),
                                      last[2].float().abs(), *last[3:])
    # the kernel phase's bf16 limit
    check_close("decode: the last layer's output", out, ref,
                1.01 * (2 ** -8 * a + BF16_ULP * ref.float().abs()) + 1e-6)
    log(f"[decode] block_multihead_attention: {batch} sequences, ctx "
        f"{int(ctx0.min())}-{int(ctx0.max())}, {L} layers x {steps} steps "
        f"in {wall * 1e3:.1f} ms ({wall / steps * 1e3:.2f} ms a step, host "
        f"clock, pool writes included); launches {launches}")

    # one more step under the profiler: its device time, and K16's share
    # of it, away from the host clock
    def one_step():
        ctx = torch.from_numpy(ctx0 + steps).to(dev)
        for i in range(L):
            kp, vp = pools[2 * i], pools[2 * i + 1]
            PA.paged_prefill_write(kp, vp, new_kv, new_kv, tb, ctx, one)
            IF.block_multihead_attention(qs[i], kp, vp, tb, ctx + 1)
    prof = _profile("decode", one_step)
    k16_ms = sum(ms for n, ms in prof.get("symbols", {}).get(
        "paged attention K12/K13/K16", {}).items())
    if prof:
        log(f"[decode] a step's device time {prof['busy_ms']:.3f} ms, K16 "
            f"{k16_ms:.3f} ms of it ({100 * k16_ms / prof['busy_ms']:.1f}%, "
            f"{L} launches); wall {prof['wall_ms']:.2f} ms")
    del pools, qs
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, step_device_ms=prof.get(
        "busy_ms"), k16_step_ms=k16_ms)


def phase_quant_accuracy(model, n_tokens=1500):
    """One ``n_tokens`` prefill through the model with bf16 pools and with
    int8 and fp8 ones: the logits' largest difference and their RMS
    difference over the logits' RMS, against the same prefill in chunks of
    256 with bf16 pools (what rounding in another order does alone), and
    the top-1 agreement over the positions.

    The gate: the RMS difference over the logits' RMS stays under 0.2
    (int8) and 0.5 (fp8). With seeded random weights the layers amplify
    the KV codes' rounding (int8 about 0.7% of an element's spread, e4m3
    about 2.5% of its size): at 32 layers to about 0.10 and 0.31 of the
    logits' RMS (this script, measured on one NVIDIA H100 80GB HBM3), the
    bounds 2x and 1.6x those; logits that share nothing with the
    bf16 pools' (a dropped scale, a wrong page) give about 1.41."""
    import torch
    rng = np.random.RandomState(9)
    tokens = rng.randint(0, model.config.vocab_size, n_tokens)
    base = _prefill_logits(model, tokens).float()
    top = base.argmax(-1)
    rms = base.square().mean().sqrt().item()
    res = {}
    for mode, chunk, limit in (("none", 256, None), ("int8", None, 0.2),
                               ("fp8", None, 0.5)):
        lq = _prefill_logits(model, tokens, mode, chunk).float()
        diff = (lq - base).abs().max().item()
        rel = ((lq - base).square().mean().sqrt() / rms).item()
        agree = (lq.argmax(-1) == top).float().mean().item()
        what = "bf16 pools, chunks of 256" if mode == "none" else \
            f"{mode} pools"
        log(f"[serve_quant] {n_tokens}-token prefill, {what}: logits max "
            f"abs diff {diff:.4g} (max |logit| {base.abs().max().item():.4g}"
            f"), RMS diff / RMS {rel:.4g} (bound {limit or '-'}), top-1 "
            f"agreement {agree:.4f}, against bf16 pools in one chunk")
        res[mode] = dict(max_abs_diff=diff, rel_rms=rel, top1=agree)
        if limit is not None and not rel <= limit:
            raise AssertionError(f"{mode} pools: RMS logit difference "
                                 f"{rel:.4g} of the RMS > {limit}")
        del lq
    del base
    torch.cuda.empty_cache()
    return res


def phase_capacity(model, dev="cuda", slots=16, base_pages=257, n_req=12,
                   n_new=32):
    """The JAX bench's equal-byte capacity A/B (bench.py:_cb_quant_bench)
    at full width: a bf16 engine whose page budget binds (256 usable
    pages) and an int8 engine holding the same bytes of pools, its page
    count from the engines' own gauges; the same requests through both,
    each engine built as the bench builds it (prefix cache on, a warm-up
    request, then ``reset_prefix_cache`` and ``reset_gauges``); the peak
    number of occupied slots after each step (bar: int8 holds 1.7x), and
    the prefix cache's resident pages after the storm. ``n_req``: the
    bench's 24 cut to 12 for the script's time limit, still twice what
    the int8 pools hold at once."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    def make(pages, mode, nslots=slots):
        return ContinuousBatchingEngine(
            model, num_slots=nslots, page_size=16, num_pages=pages,
            max_len=2048, prefill_chunk=256, decode_chunk=8,
            kv_quant=mode, audit=True, device=dev)

    base = make(base_pages, "none")
    base_bytes = base.gauges()["kv_quant_pool_bytes"]
    probe = make(base_pages, "int8", nslots=1)
    g = probe.gauges()
    per_page = (g["kv_quant_pool_bytes"]
                + g["kv_quant_scale_pool_bytes"]) / base_pages
    del probe
    q_pages = int(base_bytes // per_page)
    rng = np.random.RandomState(24)
    prompts = [rng.randint(0, model.config.vocab_size, int(n))
               for n in rng.randint(1024, 1501, n_req)]
    res = {}
    for mode, pages in (("none", base_pages), ("int8", q_pages)):
        eng = base if mode == "none" else make(q_pages, "int8")
        gq = eng.gauges()
        pool_bytes = gq["kv_quant_pool_bytes"] + gq[
            "kv_quant_scale_pool_bytes"]
        eng.add_request(prompts[0], 2)
        eng.run()                     # warm-up, off the clock
        eng.reset_prefix_cache()      # drop the warm-up's pages
        eng.reset_gauges()
        for p in prompts:
            eng.add_request(p, n_new)
        peak, done = 0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.queue or any(r is not None for r in eng.slot_req):
            done += eng.step()
            peak = max(peak, sum(r is not None for r in eng.slot_req))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(done) != n_req or any(len(r.tokens) != n_new for r in done):
            raise AssertionError(f"capacity {mode}: {len(done)} of {n_req} "
                                 f"requests completed")
        if len(eng._free_pages) + eng.prefix_cache_pages \
                != eng.num_pages - 1:
            raise AssertionError(f"capacity {mode}: pages not all returned")
        resident = eng.prefix_cache_pages
        log(f"[capacity] {mode}: {pages} pages ({pages - 1} usable), "
            f"{pool_bytes / 1e6:.1f} MB of pools, peak {peak} of {slots} "
            f"slots occupied; {n_req} requests of 1024-1500 prompt tokens "
            f"and {n_new} new in {wall:.2f} s "
            f"({n_req * n_new / wall:.1f} generated tok/s); "
            f"{resident} prefix-cache pages resident after the storm, "
            f"{eng.gauges()['prefix_cache_evictions']} evicted")
        res[mode] = dict(pages=pages, pool_bytes=pool_bytes, peak=peak,
                         wall_s=wall, resident=resident)
        if mode != "none":
            del eng
        torch.cuda.empty_cache()
    ratio = res["int8"]["peak"] / max(res["none"]["peak"], 1)
    residency = res["int8"]["resident"] / max(res["none"]["resident"], 1)
    # bytes a token and kv head: 2 * D * e (e bytes an element) against
    # 2 * D int8 codes and two f32 scales
    d, e = model.config.head_dim, base.gauges()["kv_quant_bits"] // 8
    log(f"[capacity] int8 / {e * 8}-bit: pages {q_pages / base_pages:.3f}x "
        f"at equal bytes (predicted 2*D*{e} / (2*D + 2*4) = "
        f"{2 * d * e / (2 * d + 8):.3f}), peak occupied slots "
        f"{ratio:.3f}x (bar 1.7), prefix-cache residency {residency:.3f}x")
    del base
    torch.cuda.empty_cache()
    if not (res["int8"]["peak"] > res["none"]["peak"] and ratio >= 1.7):
        raise AssertionError(f"int8 pools held fewer than 1.7x the "
                             f"requests at once: {res}")
    res["ratio"] = ratio
    res["residency"] = residency
    return res


SERVE_KERNELS = ("rms_norm", "swiglu", "ragged_paged_attention")


def serve_model_1b(cfg1b, dev="cuda"):
    """Llama-1B at full width and ``cfg1b``'s depth in bf16, seeded random
    weights (seed 1): the model of the JAX bench's prefix and overload
    sections."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg1b, device=dev, dtype=torch.bfloat16,
                             seed=1)
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[prefix] Llama-1B {cfg1b.num_hidden_layers} layers, "
        f"{n_params / 1e9:.2f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def _p99(ms):
    """bench.py's p99: the nearest rank of the sorted values."""
    ms = sorted(ms)
    return ms[max(0, int(round(0.99 * (len(ms) - 1))))] if ms else 0.0


def _launch_check(tag, launches, forwards, n_layers, attn=None,
                  draft_forwards=0, draft_layers=0):
    """Each forward launches 2L + 1 RMSNorms, L SwiGLUs and L ragged
    attentions (K12, or ``attn``: K13 over quantized pools); a
    self-speculative draft forward the same over its ``draft_layers``."""
    attn = attn or "ragged_paged_attention"
    want = {n: 0 for n in launches}
    want.update({
        "rms_norm": (2 * n_layers + 1) * forwards
        + (2 * draft_layers + 1) * draft_forwards,
        "swiglu": n_layers * forwards + draft_layers * draft_forwards,
        attn: n_layers * forwards + draft_layers * draft_forwards})
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want} for "
                             f"{forwards} forwards")


def phase_prefix(model, dev="cuda"):
    """The JAX bench's shared-prefix storm (bench.py:_cb_prefix_bench) with its
    TPU configuration: Llama-1B bf16, 8 slots, page 32, decode chunk 32,
    prefill chunk 256, max_len 768; 32 requests (the bench's 64, cut for the
    script's time limit) sharing one 512-token prefix, each with a tail of
    0-63 tokens, 32 new. One engine runs the storm cold (after
    ``reset_prefix_cache``), then warm; an engine with the cache off runs it
    too. The three must give the same greedy streams, the warm hit rate must
    be positive and the page audit must balance. Launches are counted over
    the three storms."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    cfg = model.config
    n_req, prefix_len, tail_hi, n_new = 32, 512, 64, 32
    rng = np.random.RandomState(55)
    prefix = rng.randint(0, cfg.vocab_size, (prefix_len,)).astype(np.int32)
    specs = [(np.concatenate([prefix, rng.randint(
        0, cfg.vocab_size, (int(rng.randint(0, tail_hi)),)).astype(
            np.int32)]), n_new) for _ in range(n_req)]
    prompt_tokens = sum(len(p) for p, _ in specs)

    def make(**kw):
        eng = ContinuousBatchingEngine(
            model, num_slots=8, page_size=32, max_len=768, decode_chunk=32,
            prefill_chunk=256, greedy=True, audit=True, device=dev, **kw)
        eng.add_request(specs[0][0], 2)
        eng.run()                     # warm-up, off the clock
        return eng

    def storm(eng):
        eng.reset_gauges()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.add_request(p, n) for p, n in specs]
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by = {r.request_id: r for r in done}
        if sorted(by) != sorted(ids) or any(
                by[i].error is not None or len(by[i].tokens) != n_new
                for i in ids):
            raise AssertionError("[prefix] a request did not complete")
        if len(eng._free_pages) + eng.prefix_cache_pages \
                != eng.num_pages - 1:
            raise AssertionError("[prefix] pages not all returned")
        eng._audit_pages("prefix phase")
        ttft = [(by[i].t_first - by[i].t_arrive) * 1e3 for i in ids]
        return dict(tok_s=n_req * n_new / wall, wall_s=wall,
                    p99_ttft_ms=_p99(ttft), gauges=eng.gauges(),
                    forwards=eng._stats["forwards"],
                    streams=[by[i].tokens for i in ids])

    eng = make()
    off = make(prefix_cache=False)
    eng.reset_prefix_cache()          # drop the warm-up's pages
    wrappers = _counted(SERVE_KERNELS)
    cold, warm, cache_off = storm(eng), storm(eng), storm(off)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    _launch_check("prefix", launches,
                  sum(r["forwards"] for r in (cold, warm, cache_off)),
                  cfg.num_hidden_layers)
    for name, r in (("cold", cold), ("warm", warm)):
        if r["streams"] != cache_off["streams"]:
            diff = [i for i, (a, b) in enumerate(
                zip(r["streams"], cache_off["streams"])) if a != b]
            raise AssertionError(f"[prefix] {name} streams differ from "
                                 f"the cache-off engine's at {diff}")
    g = warm["gauges"]
    if not g["prefix_cache_hit_rate"] > 0:
        raise AssertionError(f"[prefix] warm hit rate {g}")
    saved = g["prefix_cache_tokens_saved"] / prompt_tokens
    for name, r in (("cold", cold), ("warm", warm), ("off", cache_off)):
        rg = r["gauges"]
        log(f"[prefix] {name}: {n_req} requests x {prefix_len}-token "
            f"prefix in {r['wall_s']:.2f} s, {r['tok_s']:.1f} generated "
            f"tok/s, p99 TTFT {r['p99_ttft_ms']:.1f} ms, hit rate "
            f"{rg['prefix_cache_hit_rate']:.4f}, prefill tokens saved "
            f"{rg['prefix_cache_tokens_saved'] / prompt_tokens:.4f}, "
            f"{rg['prefix_cache_cow_forks']} COW forks, "
            f"{rg['unified_steps']} steps")
    log(f"[prefix] greedy streams identical cold, warm and cache off; "
        f"warm hit rate {g['prefix_cache_hit_rate']:.4f}, prefill tokens "
        f"saved {saved:.4f}, COW forks {g['prefix_cache_cow_forks']}, "
        f"p99 TTFT cold/warm/off {cold['p99_ttft_ms']:.1f} / "
        f"{warm['p99_ttft_ms']:.1f} / {cache_off['p99_ttft_ms']:.1f} ms; "
        f"launches {launches}")
    del eng, off
    torch.cuda.empty_cache()
    return dict(launches=launches, hit_rate=g["prefix_cache_hit_rate"],
                saved_frac=saved, cow_forks=g["prefix_cache_cow_forks"],
                **{f"{n}_{k}": r[k] for n, r in (("cold", cold),
                                                 ("warm", warm),
                                                 ("off", cache_off))
                   for k in ("tok_s", "p99_ttft_ms")})


def phase_overload(model, dev="cuda"):
    """The JAX bench's overload section (bench.py:_cb_overload_bench) with its
    TPU configuration: Llama-1B bf16, 8 slots, page 32, decode chunk 32,
    max_len 384; 48 requests (the bench's 96, cut for the script's time
    limit) of 48-192 prompt tokens and 32-96 new, priorities 0-2, seed 33, a
    TTFT SLO of 30 s and a total one of 120 s, through an
    ``AdmissionController`` (max_queue half the requests) over an
    ``EngineSupervisor`` (two restarts). Every accepted request must
    complete or end with a typed error, and no page may leak. Then a poison
    request (``poison_request``, twice) and an innocent one: the poison is
    quarantined and the innocent's stream equals its solo run."""
    import torch
    from paddle_tpu_torch.inference import (AdmissionController,
                                            EngineSupervisor, Overloaded,
                                            RequestQuarantined,
                                            ServingError)
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.testing import FaultInjector
    cfg = model.config
    n_req, plen_lo, plen_hi, new_lo, new_hi = 48, 48, 192, 32, 96
    ttft_slo_s, total_slo_s = 30.0, 120.0

    def factory():
        return ContinuousBatchingEngine(
            model, num_slots=8, page_size=32, max_len=384, decode_chunk=32,
            greedy=True, audit=True, device=dev)

    warm = factory()                  # cuBLAS handles, off the clock
    warm.add_request(np.arange(100) % cfg.vocab_size, 4)
    warm.run()
    del warm
    sup = EngineSupervisor(factory, max_restarts=2)
    adm = AdmissionController(sup, max_queue=n_req // 2,
                              default_ttft_slo_s=ttft_slo_s)
    rng = np.random.RandomState(33)
    accepted, shed = [], 0
    wrappers = _counted(SERVE_KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_req):
        plen = int(rng.randint(plen_lo, plen_hi + 1))
        n_new = int(rng.randint(new_lo, new_hi + 1))
        try:
            accepted.append(adm.submit(
                rng.randint(0, cfg.vocab_size, (plen,)).astype(np.int32),
                n_new, priority=int(rng.randint(0, 3)),
                ttft_deadline_s=ttft_slo_s, deadline_s=total_slo_s))
        except Overloaded:
            shed += 1
    done = sup.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    by = {r.request_id: r for r in done}
    for rid in accepted:
        r = by.get(rid)
        if r is None or not r.finished or not (
                isinstance(r.error, ServingError) if r.error is not None
                else r.finish_reason in ("eos", "length")):
            raise AssertionError(f"[overload] request {rid} neither "
                                 f"completed nor ended with a typed error")
    eng = sup.engine
    if len(eng._free_pages) + eng.prefix_cache_pages != eng.num_pages - 1 \
            or eng._deferred_free or any(eng.slot_pages):
        raise AssertionError("[overload] pages leaked")
    eng._audit_pages("overload phase")
    g = sup.gauges()
    if sup.restarts == 0:
        _launch_check("overload", launches, eng._stats["forwards"],
                      cfg.num_hidden_layers)
    ok = [by[i] for i in accepted if by[i].error is None]
    toks = sum(len(r.tokens) for r in ok)
    ttft = [(r.t_first - r.t_arrive) * 1e3 for r in ok if r.t_first]
    met = [r for r in ok if r.t_first - r.t_arrive <= ttft_slo_s
           and r.t_done - r.t_arrive <= total_slo_s]
    res = dict(launches=launches, tok_s=toks / wall, p99_ttft_ms=_p99(ttft),
               shed_frac=shed / n_req,
               preempt_rate=g["preempt_evictions"] / max(1, len(accepted)),
               goodput=len(met) / max(1, len(accepted)),
               restarts=sup.restarts)
    log(f"[overload] {n_req} offered / {len(accepted)} accepted / {shed} "
        f"shed, {toks} tokens in {wall:.2f} s ({res['tok_s']:.1f} tok/s), "
        f"p99 TTFT {res['p99_ttft_ms']:.1f} ms, shed share "
        f"{res['shed_frac']:.4f}, preemption rate "
        f"{res['preempt_rate']:.4f}, goodput {res['goodput']:.4f}, "
        f"restarts {sup.restarts}, {g['unified_steps']} steps; no page "
        f"leaked; launches {launches}")
    del sup, adm, eng
    # containment on the card: a poisoned request and an innocent one
    rng = np.random.RandomState(34)
    poison, innocent = (rng.randint(0, cfg.vocab_size, n) for n in (64, 96))
    solo = factory()
    solo.add_request(innocent, 24)
    want = solo.run()[0].tokens
    del solo
    eng = factory()
    rp = eng.add_request(poison, 24)
    ri = eng.add_request(innocent, 24)
    with FaultInjector() as fi:
        fi.poison_request(rp, times=2)
        eng.run()
        fires = fi.fires()
    got = {r.request_id: r for r in eng.completed}
    if not isinstance(got[rp].error, RequestQuarantined) \
            or got[ri].error is not None or got[ri].tokens != want:
        raise AssertionError(f"[overload] containment: poison "
                             f"{got[rp].error!r}, innocent "
                             f"{got[ri].error!r} {got[ri].tokens} vs {want}")
    if len(eng._free_pages) + eng.prefix_cache_pages != eng.num_pages - 1:
        raise AssertionError("[overload] containment leaked pages")
    gc = eng.gauges()
    log(f"[overload] poison request quarantined after {fires} injected "
        f"harvest failures ({gc['containments']} containments); the "
        f"innocent's {len(want)} tokens equal its solo run")
    del eng
    torch.cuda.empty_cache()
    return res


def _drain_check(tag, eng):
    if len(eng._free_pages) + eng.prefix_cache_pages != eng.num_pages - 1:
        raise AssertionError(f"[{tag}] pages not all returned")
    eng._audit_pages(tag)


def _first_diff(a, b):
    """(stream index, token index) of each pair of streams that differ."""
    return [(i, next((j for j, (u, w) in enumerate(zip(x, y)) if u != w),
                     min(len(x), len(y))))
            for i, (x, y) in enumerate(zip(a, b)) if x != y]


#: the fleet's and the HTTP front door's geometry on Llama-1B: the JAX
#: bench's TPU configuration (bench.py:_cb_fleet_bench, _cb_http_bench)
FLEET_ENGINE = dict(num_slots=8, page_size=32, max_len=384, decode_chunk=32,
                    greedy=True, audit=True)
#: the fleet's traffic cut to 24 of the bench's 64 requests, and replica
#: 1 killed after 4 of its steps (the bench: 8), for the script's time
#: limit: at 24 requests replica 1 takes fewer than 8 steps. Phase fleet
#: runs 16 of them with the kill after 2 steps (fleet_parity's geometry),
#: the process-backed phases all 24
FLEET_REQUESTS = 24
FLEET_KILL_AFTER = 2
FLEET_TIMED_REQUESTS = 16
#: fleet_parity's requests, and its kill after 2 of replica 1's steps
#: (every request of 48-192 prompt tokens at chunk 32 still runs at its
#: third), cut for the script's time limit
FLEET_PARITY_REQUESTS = 16
FLEET_PARITY_KILL_AFTER = 2


def _fleet_specs(vocab, n_req=FLEET_REQUESTS, plen=(48, 192), new=(16, 48),
                 seed=44):
    """The bench's fleet traffic: RandomState(44), prompts of 48-192
    tokens, 16-48 new each; ``FLEET_REQUESTS`` of them."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (int(rng.randint(plen[0], plen[1] + 1)),))
             .astype(np.int32), int(rng.randint(new[0], new[1] + 1)))
            for _ in range(n_req)]


def _fleet_factory(model, dev, engines=None):
    """The fleet's engine factory; ``engines`` collects every engine it
    builds (a supervised restart builds more), for their forwards."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    def factory():
        eng = ContinuousBatchingEngine(model, prefill_chunk=32, device=dev,
                                       **FLEET_ENGINE)
        if engines is not None:
            engines.append(eng)
        return eng
    return factory


def _delivered(tag, fleet, done, fids):
    """Every fleet id delivered exactly once and without an error, and
    the pages of every surviving in-process replica balanced (a worker
    process's pages: ``_worker_launches``'s audit). Returns {fid: req}."""
    from paddle_tpu_torch.inference import ProcReplica
    by = {}
    for r in done:
        if r.request_id in by:
            raise AssertionError(f"[{tag}] fleet id {r.request_id} "
                                 f"delivered twice")
        by[r.request_id] = r
    bad = [f for f in fids if f not in by or by[f].error is not None]
    if sorted(by) != sorted(fids) or bad:
        raise AssertionError(f"[{tag}] {len(by)}/{len(fids)} delivered; "
                             f"failed or missing {bad[:8]}")
    for rep in fleet.replicas.values():
        if rep.live() and not isinstance(rep, ProcReplica):
            _drain_check(f"{tag} replica {rep.id}", rep.engine)
    return by


def phase_fleet(model, dev="cuda"):
    """The JAX bench's fleet section (bench.py:_cb_fleet_bench) on the
    port: Llama-1B bf16, engines of 8 slots, page 32, prefill and
    decode chunk 32, max_len 384; ``FLEET_TIMED_REQUESTS`` requests (the
    bench's 64; RandomState(44), prompts of 48-192 tokens, 16-48 new)
    through one engine (the A/B
    denominator), then through a ``ServingFleet`` of 4 replicas sharing
    the model (``max_restarts=1``, the bench's two SLO rules, two
    tenants), each replica warmed outside the timed region, replica 1
    killed for good after ``FLEET_KILL_AFTER`` of its steps. Every
    request must be
    delivered without an error, replica 1's breaker must be open and
    every survivor's pages must balance. The bench's keys, the launches
    per forward (exact), the share of greedy streams equal to the single
    engine's (a differing stream's first differing position and the
    top-2 logit gap there), and the idle share over a profiled window of
    the same requests at the same concurrency."""
    import torch
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.profiler.slo import SLORule
    from paddle_tpu_torch.testing import FaultInjector
    cfg = model.config
    specs = _fleet_specs(cfg.vocab_size, n_req=FLEET_TIMED_REQUESTS)
    single = _fleet_factory(model, dev)()
    single.add_request(*specs[0])
    single.run()                       # cuBLAS handles, off the clock
    single.reset_gauges()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [single.add_request(p, n) for p, n in specs]
    sdone = {r.request_id: r for r in single.run()}
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    single_streams = [sdone[i].tokens for i in ids]
    single_tps = sum(len(t) for t in single_streams) / single_wall
    del single
    engines = []
    fleet = ServingFleet(
        _fleet_factory(model, dev, engines), num_replicas=4, max_restarts=1,
        retry_backoff_s=0.01,
        slo_rules=[SLORule("ttft", kind="ttft", threshold_ms=60_000,
                           target=0.9, min_events=5),
                   SLORule("success", kind="success", target=0.9,
                           min_events=5)])
    for rep in fleet.replicas.values():
        fleet._warm(rep)               # first-use work, off the clock
    wrappers = _counted(SERVE_KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with FaultInjector() as fi:
        fi.kill_replica(1, times=10_000, after_steps=FLEET_KILL_AFTER)
        fids = [fleet.submit(p, n, tenant=f"tenant{i % 2}")
                for i, (p, n) in enumerate(specs)]
        done = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = sum(e._stats["forwards"] for e in engines)
    _launch_check("fleet", launches, forwards, cfg.num_hidden_layers)
    by = _delivered("fleet", fleet, done, fids)
    g = fleet.gauges()
    if g["breaker_open"] != 1 or fleet.replicas[1].eject_kind != "breaker":
        raise AssertionError(f"[fleet] replica 1's breaker is not open: "
                             f"{g['replica_states']}, {g['breaker_open']}")
    streams = [by[f].tokens for f in fids]
    toks = sum(len(t) for t in streams)
    ttft = [(by[f].t_first - by[f].t_arrive) * 1e3 for f in fids]
    slo = fleet.slo.summary()
    out = {"cb_fleet_tok_s": round(toks / wall, 2),
           "cb_fleet_p99_ttft_ms": round(_p99(ttft), 2),
           "cb_fleet_failover_ms": round(g["failover_ms_p99"], 2),
           "cb_fleet_vs_single": round(toks / wall / single_tps, 4),
           "obs_slo_attainment": round(slo["worst_attainment"], 4),
           "slo_alerts": int(slo["alerts_fired"]),
           "obs_fleet_overhead_frac": round(g["obs_overhead_frac"], 5)}
    same = sum(a == b for a, b in zip(streams, single_streams))
    log(f"[fleet] {len(fids)} requests over 4 replicas, replica 1 killed "
        f"after {FLEET_KILL_AFTER} steps (breaker open, {g['requeued']} "
        f"requeued, "
        f"{g['retries']} retries): {toks} tokens in {wall:.2f} s; single "
        f"engine {single_tps:.1f} tok/s in {single_wall:.2f} s; "
        f"{json.dumps(out)}")
    log(f"[fleet] launches {launches} over {forwards} forwards: "
        f"{launches['rms_norm'] / forwards:g} rms_norm, "
        f"{launches['swiglu'] / forwards:g} swiglu, "
        f"{launches['ragged_paged_attention'] / forwards:g} "
        f"ragged_paged_attention a forward")
    log(f"[fleet] bf16 greedy streams equal to the single engine's: "
        f"{same}/{len(fids)}")
    for i, j in _first_diff(streams, single_streams):
        gap = _top2_gap(model, list(specs[i][0]) + single_streams[i][:j])
        log(f"[fleet] stream {i} first differs at token {j}: the single "
            f"engine's top-2 logit gap there is {gap:.4g}")
    # the idle share over a window of the phase's own traffic: the
    # requests again through the three survivors (every slot taken, the
    # rest queued), 2 turns to fill, then 3 turns under the profiler
    # (device activity only, the least host overhead); the window's
    # device time a forward, over the timed run's forwards and wall, is
    # the profiler-free reading. The window's requests are left undone
    for i, (p, n) in enumerate(specs):
        fleet.submit(p, n, tenant=f"tenant{i % 2}")
    for _ in range(2):
        fleet.step()
    f0 = sum(e._stats["forwards"] for e in engines)
    prof = _profile("fleet", lambda: [fleet.step() for _ in range(3)],
                    cpu=False)
    fw = sum(e._stats["forwards"] for e in engines) - f0
    if prof:
        per_fwd = prof["busy_ms"] / fw
        log(f"[fleet] profiled window: 3 fleet turns of the {len(specs)} "
            f"requests "
            f"over 3 replicas, {fw} forwards, {per_fwd:.3f} ms of device "
            f"time a forward; over the timed run's {forwards} forwards in "
            f"{wall:.2f} s that is an idle share of "
            f"{1 - per_fwd * forwards / (wall * 1e3):.3f} (the window's "
            f"own, profiler on: {1 - prof['busy_ms'] / prof['wall_ms']:.3f})")
    del fleet, engines
    torch.cuda.empty_cache()
    return dict(out, launches=launches)


def phase_fleet_parity(cfg1b, layers=2, dev="cuda"):
    """The fleet at Llama-1B's width and depth 2 in f32 (seed 1), the
    fleet phase's geometry and the first ``FLEET_PARITY_REQUESTS`` of its
    requests: every fleet stream must equal
    the single engine's bit for bit through the kill of replica 1 after
    ``FLEET_PARITY_KILL_AFTER`` steps; then again with the
    kill and hedges (``hedge_factor`` 0.05, so that requests waiting for
    their first token are copied), and again with the kill and a
    ``scale_down`` of replica 0 whose deadline has passed (its
    stragglers go through ``handoff()``). Every fleet id is delivered
    exactly once in each run."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.testing import FaultInjector
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
    model.eval()
    specs = _fleet_specs(cfg.vocab_size, n_req=FLEET_PARITY_REQUESTS)
    single = _fleet_factory(model, dev)()
    ids = [single.add_request(p, n) for p, n in specs]
    sdone = {r.request_id: r for r in single.run()}
    want = [sdone[i].tokens for i in ids]
    del single
    res = {}
    for mode in ("kill", "hedge", "drain"):
        fleet = ServingFleet(
            _fleet_factory(model, dev), num_replicas=4, max_restarts=1,
            retry_backoff_s=0.01, hedge_factor=0.05, hedge_min_delay_s=0.0,
            hedge_delay_s=None if mode == "hedge" else 1e9)
        for rep in fleet.replicas.values():
            fleet._warm(rep)
        with FaultInjector() as fi:
            fi.kill_replica(1, times=10_000,
                            after_steps=FLEET_PARITY_KILL_AFTER)
            fids = [fleet.submit(p, n) for p, n in specs]
            if mode == "drain":
                for _ in range(3):
                    fleet.step()
                fleet.scale_down(0, deadline_s=0.0)
            fleet.run()
        # fleet.completed: every delivery, those of the turns before run()
        by = _delivered(f"fleet_parity {mode}", fleet, fleet.completed,
                        fids)
        got = [by[f].tokens for f in fids]
        if got != want:
            raise AssertionError(f"[fleet_parity] {mode}: f32 streams "
                                 f"differ at {_first_diff(got, want)[:4]}")
        g = fleet.gauges()
        if g["breaker_open"] != 1:
            raise AssertionError(f"[fleet_parity] {mode}: breaker {g}")
        if mode == "hedge" and not g["hedges"]:
            raise AssertionError("[fleet_parity] no hedge fired")
        if mode == "drain" and (g["drains"] != 1 or fleet.replicas[0].state
                                != "retired"):
            raise AssertionError(f"[fleet_parity] drain: {g}")
        res[mode] = {k: g[k] for k in ("requeued", "retries", "hedges",
                                       "hedge_wins", "hedge_cancels",
                                       "drains")}
        log(f"[fleet_parity] {mode}: {len(fids)} f32 greedy streams equal "
            f"to the single engine's bit for bit, each fleet id delivered "
            f"once; {res[mode]}")
        del fleet
    del model
    torch.cuda.empty_cache()
    return res


# ---- the process half of serving: worker processes, disaggregation, the
# autoscaler --------------------------------------------------------------

#: the process-backed fleet (bench.py:_cb_procfleet_bench) on the card: 4
#: worker processes, each a Llama-1B at 4 of its 16 layers (the depth the
#: script serves Llama-1B at; 8 until the sep cases came in, and still
#: in disagg and autoscale) with FLEET_ENGINE's geometry; replica 1's
#: worker SIGKILLed before its 2nd step RPC twice, which spends its one
#: respawn and opens its breaker (bench: the tiny CPU model; the script's
#: time limit allows one respawn)
PROC_WORKERS = 4
PROC_MODEL = "llama_1b"          # the workers' LlamaConfig preset
PROC_LAYERS = 8
PROCFLEET_LAYERS = 4
PROC_MAX_RESTARTS = 1
PROC_KILLS = 2
#: the front-door leg on the survivors (the bench's)
PROC_HTTP_REQUESTS = 12
PROC_HTTP_CONCURRENCY = 4
#: a worker's deadlines on the card: spawn to ready (import torch, the
#: CUDA context, the model) within init_deadline_s; heartbeats every 0.2
#: s, hung after hb_timeout_s of silence
PROC_REPLICA = dict(init_deadline_s=300.0, hb_timeout_s=10.0,
                    respawn_backoff_s=0.01)
#: disagg (bench.py:_cb_disagg_bench): 48 of its 128 requests, its role
#: geometry (bench.py:1335-1337, 1385-1395) at Llama-1B width, 8 layers;
#: 1 prefill + 1 decode worker against 2 colocated (the bench's 2 + 2
#: against 4), cut for the script's time limit (64 until the pipeline's
#: cases came in)
DISAGG_REQUESTS = 48
DISAGG_ENGINE = dict(num_slots=2, page_size=8, max_len=64, num_pages=48,
                     decode_chunk=4, prompt_buckets=(8, 40), greedy=True)
DISAGG_PREFILL = dict(role="prefill", decode_chunk=2, num_slots=6,
                      num_pages=96)
#: the depth-2 f32/int8 identity check's requests: the mix's first 48
DISAGG_PARITY_REQUESTS = 48
DISAGG_DECODE = dict(role="decode", prompt_buckets=(8,))
#: the chunked-wire check's prompt: 7 pages of 32 at 8 layers is 7.3 MB
#: of bf16 KV, 9.8 MB in base64, past the wire's 8 MiB frame cap
DISAGG_CHUNKED_PROMPT = 224
#: autoscale (bench.py:_cb_autoscale_bench's flash_crowd leg): its engine
#: geometry, controller and seed at Llama-1B width, 8 layers
AUTOSCALE_ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
                        prompt_buckets=(8, 16), greedy=True)
AUTOSCALE_CTL = dict(min_replicas=1, max_replicas=3, up_cooldown_s=2.0,
                     down_cooldown_s=3.0, queue_high=3.0, queue_low=0.5,
                     down_stable_ticks=3)
AUTOSCALE_STEPS_PER_TICK = 2
AUTOSCALE_SEED = 23
#: the JAX scenario test's window: a scale-up within 7 ticks of onset
AUTOSCALE_ONSET_TICKS = 7


def _matmul_settings():
    """TF32 off and bf16 products reduced in f32, in this process (the
    set-up) and in a worker (``card_llama_engine``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def card_llama_engine(**kw):
    """A worker's engine factory on the card (``chip_smoke:card_llama_
    engine``): the set-up's matmul settings, then the port's
    ``inference.worker.llama_engine``, so a worker's forward is the
    parent's bit for bit."""
    from paddle_tpu_torch.inference.worker import llama_engine
    _matmul_settings()
    return llama_engine(**kw)


def _proc_spec(layers, dtype, seed, dev, **engine):
    return {"factory": "chip_smoke:card_llama_engine",
            "kwargs": dict(model=PROC_MODEL, num_hidden_layers=layers,
                           seed=seed, dtype=dtype, device=dev, **engine)}


def _load_harness():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    try:
        import load_harness
    finally:
        sys.path.pop(0)
    return load_harness


def _worker_launches(tag, fleet, n_layers, attn=None):
    """Each live worker's audit: pages balanced, no exported prefix left
    pinned, its kernels loaded from the set-up's build (not compiled
    again), its device the card's, and its kernels' launches a forward
    exact. Returns the launches summed over the workers."""
    import torch
    card = torch.cuda.get_device_name(0)
    total = {}
    for rep in fleet.replicas.values():
        if not rep.live():
            continue
        a = rep.audit()
        if not a["clean"] or a["pins"] or a["kernels_compiled"]:
            raise AssertionError(f"[{tag}] worker {rep.id} audit {a}")
        if rep.worker_device != card:
            raise AssertionError(f"[{tag}] worker {rep.id} runs on "
                                 f"{rep.worker_device!r}, not {card!r}")
        _launch_check(f"{tag} worker {rep.id}", a["launches"],
                      a["forwards"], n_layers, attn=attn)
        for k, v in a["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def _streams_vs(tag, model, specs, got, want):
    """Log the share of ``got`` streams equal to ``want`` and, for each
    that differs, the first differing position and ``want``'s top-2
    logit gap there."""
    same = sum(a == b for a, b in zip(got, want))
    log(f"[{tag}] bf16 greedy streams equal to the single engine's: "
        f"{same}/{len(want)}")
    for i, j in _first_diff(got, want)[:4]:
        gap = _top2_gap(model, list(specs[i][0]) + want[i][:j])
        log(f"[{tag}] stream {i} first differs at token {j}: the single "
            f"engine's top-2 logit gap there is {gap:.4g}")
    return same


def phase_procfleet(cfg1b, layers=PROCFLEET_LAYERS, dev="cuda"):
    """bench.py:_cb_procfleet_bench on the card at full width: a
    ``ServingFleet`` of ``PROC_WORKERS`` ``ProcReplica`` worker processes
    (``python -m paddle_tpu_torch.inference.worker``, Popen, each with
    its own CUDA context), each a Llama-1B of ``layers`` layers in bf16
    from seed 0 with FLEET_ENGINE's geometry and prefill chunk 32, the
    fleet's traffic (``_fleet_specs``); replica 1's worker SIGKILLed by
    ``kill_worker(1, times=3, after_steps=1)`` spends its 2 respawns and
    opens its breaker. The same requests and kill (``kill_replica``) go
    through the in-process fleet over a model from the same seed. Every
    fleet id must be delivered once without an error, replica 1's breaker
    open, each survivor's audit balanced, each worker's ``init`` naming
    the card and its launches a forward exact. Then the survivors serve
    ``PROC_HTTP_REQUESTS`` requests at concurrency
    ``PROC_HTTP_CONCURRENCY`` through an ``ApiServer`` mounted on the
    process-backed fleet (tools/load_harness.py as a process). The
    workers boot while this process runs the single engine."""
    import dataclasses
    import tempfile

    import torch
    from paddle_tpu_torch.inference import (ApiServer, ProcReplica,
                                            ServingFleet)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.testing import FaultInjector
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    specs = _fleet_specs(cfg.vocab_size)
    torch.cuda.empty_cache()
    fleet = ServingFleet(
        _proc_spec(layers, "bfloat16", 0, dev, prefill_chunk=32,
                   **FLEET_ENGINE),
        num_replicas=PROC_WORKERS, max_restarts=PROC_MAX_RESTARTS,
        retry_backoff_s=0.01, replica_cls=ProcReplica,
        replica_kwargs=PROC_REPLICA)
    srv = None
    try:
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=0)
        model.eval()
        single = _fleet_factory(model, dev)()
        ids = [single.add_request(p, n) for p, n in specs]
        sdone = {r.request_id: r for r in single.run()}
        want = [sdone[i].tokens for i in ids]
        del single
        for rep in fleet.replicas.values():
            rep._ensure_ready()
        ready_all = time.perf_counter() - t_phase
        spawn_s = [rep.spawn_ready_s[0] for rep in fleet.replicas.values()]
        factory_s = [rep.factory_s[0] for rep in fleet.replicas.values()]

        def leg(tag, fl, plant):
            for rep in fl.replicas.values():
                fl._warm(rep)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with FaultInjector() as fi:
                plant(fi)
                fids = [fl.submit(p, n) for p, n in specs]
                done = fl.run()
            wall = time.perf_counter() - t0
            by = _delivered(tag, fl, done, fids)
            if fl.replicas[1].eject_kind != "breaker" \
                    or fl.gauges()["breaker_open"] != 1:
                raise AssertionError(f"[{tag}] replica 1's breaker is not "
                                     f"open: {fl.gauges()['replica_states']}")
            streams = [by[f].tokens for f in fids]
            ttft = [(by[f].t_first - by[f].t_arrive) * 1e3 for f in fids]
            return (streams, sum(map(len, streams)) / wall, _p99(ttft),
                    wall, fi)

        inproc = ServingFleet(_fleet_factory(model, dev),
                              num_replicas=PROC_WORKERS,
                              max_restarts=PROC_MAX_RESTARTS,
                              retry_backoff_s=0.01)
        in_streams, in_tps, in_p99, in_wall, _ = leg(
            "procfleet in-process", inproc,
            lambda fi: fi.kill_replica(1, times=PROC_KILLS, after_steps=1))
        del inproc
        torch.cuda.empty_cache()          # the respawns' room
        streams, tps, p99, wall, fi = leg(
            "procfleet", fleet, lambda fi: fi.kill_worker(
                1, times=PROC_KILLS, after_steps=1))
        g = fleet.gauges()
        rep1 = fleet.replicas[1]
        if fi.fires() != PROC_KILLS or rep1.respawns != PROC_MAX_RESTARTS:
            raise AssertionError(f"[procfleet] {fi.fires()} kills, "
                                 f"{rep1.respawns} respawns")
        _worker_launches("procfleet", fleet, layers)
        harness = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tools", "load_harness.py")
        srv = ApiServer(fleet).start()
        with tempfile.TemporaryDirectory() as tmp:
            rep_path = os.path.join(tmp, "report.json")
            proc = subprocess.run(
                [sys.executable, harness, "--url", srv.url,
                 "--requests", str(PROC_HTTP_REQUESTS),
                 "--concurrency", str(PROC_HTTP_CONCURRENCY),
                 "--mode", "closed", "--vocab", str(cfg.vocab_size),
                 "--prompt-len", "3", "5", "--max-new", "2", "6",
                 "--seed", "44", "--report", rep_path],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"[procfleet] load harness failed "
                                     f"({proc.returncode}): "
                                     f"{proc.stderr[-800:]}")
            with open(rep_path) as f:
                report = json.load(f)
        if report["completed_ok"] != report["requests"] or report["errors"]:
            raise AssertionError(f"[procfleet] http {report['completed_ok']}"
                                 f"/{report['requests']} ok, errors "
                                 f"{report['errors']}")
        srv.stop()
        srv = None
        # the survivors' counts since their warm-up: the timed run and
        # the front door's requests
        launches = _worker_launches("procfleet http", fleet, layers)
    finally:
        if srv is not None:
            srv.stop()
        fleet.close()
    out = {"cb_procfleet_tok_s": round(tps, 2),
           "cb_procfleet_p99_ttft_ms": round(p99, 2),
           "cb_procfleet_failover_ms": round(g["failover_ms_p99"], 2),
           "cb_procfleet_vs_inproc": round(tps / in_tps, 4),
           "cb_procfleet_http_goodput_frac": round(report["goodput_frac"],
                                                   4)}
    log(f"[procfleet] {len(specs)} requests over {PROC_WORKERS} worker "
        f"processes on the card ({layers} layers bf16 each), worker 1 "
        f"SIGKILLed {PROC_KILLS} times ({rep1.respawns} respawns, breaker "
        f"open, {g['requeued']} requeued, {g['retries']} retries, "
        f"{g['hedges']} hedges): {sum(map(len, streams))} tokens in "
        f"{wall:.2f} s; in-process fleet {in_tps:.1f} tok/s in "
        f"{in_wall:.2f} s (p99 TTFT {in_p99:.1f} ms); {json.dumps(out)}")
    log(f"[procfleet] spawn to ready {', '.join(f'{s:.1f}' for s in spawn_s)}"
        f" s (the engine factory {', '.join(f'{s:.1f}' for s in factory_s)}"
        f" of them; all {PROC_WORKERS} ready {ready_all:.1f} s after the "
        f"spawn, the single engine's run beside it), respawns "
        f"{', '.join(f'{s:.1f}' for s in rep1.spawn_ready_s[1:])} s "
        f"(factory {', '.join(f'{s:.1f}' for s in rep1.factory_s[1:])}); "
        f"every worker's init names {rep1.worker_device}")
    log(f"[procfleet] survivors' launches over the timed run and the "
        f"front door: {launches} ({2 * layers + 1}/{layers}/{layers} a "
        f"forward, exact); http "
        f"{report['completed_ok']}/{report['requests']} ok at "
        f"concurrency {PROC_HTTP_CONCURRENCY}, {report['tok_s']:.1f} tok/s")
    _streams_vs("procfleet", model, specs, streams, want)
    log(f"[procfleet] in-process fleet's streams equal to the single "
        f"engine's: {sum(a == b for a, b in zip(in_streams, want))}/"
        f"{len(want)}; phase {time.perf_counter() - t_phase:.1f} s")
    del model
    torch.cuda.empty_cache()
    return dict(out, launches=launches)


def phase_proc_parity(cfg1b, layers=2, dev="cuda"):
    """Two worker processes at Llama-1B width and depth ``layers`` in f32
    (seed 1) with the fleet geometry, the fleet's traffic: one run takes
    ``kill_worker(1)`` (salvaged from the parent's shadow: with no
    respawn budget its breaker opens and replica 0 replays its
    requests), two dropped frames (tx) and two corrupted ones (rx) on
    replica 0; a second a ``pause_worker(1)`` (SIGSTOP: classified as
    hung by its heartbeats, SIGTERM then SIGKILL, ejected as wedged,
    never through the breaker). In both every fleet id is delivered once
    and every stream equals the single engine's bit for bit. Both runs'
    workers boot together, while this process runs the single engine."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import ProcReplica, ServingFleet
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.testing import FaultInjector
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    specs = _fleet_specs(cfg.vocab_size)
    spec = _proc_spec(layers, "float32", 1, dev, prefill_chunk=32,
                      **FLEET_ENGINE)
    plans = {
        "kill": (dict(PROC_REPLICA, rpc_deadline_s=0.5), lambda fi: (
            fi.kill_worker(1, after_steps=2),
            fi.drop_frame(0, times=2, direction="tx", after_frames=6),
            fi.corrupt_frame(0, times=2, direction="rx", after_frames=12))),
        "pause": (dict(PROC_REPLICA, hb_timeout_s=3.0, term_grace_s=0.5),
                  lambda fi: fi.pause_worker(1, after_steps=2))}
    torch.cuda.empty_cache()
    fleets = {mode: ServingFleet(spec, num_replicas=2, max_restarts=0,
                                 retry_backoff_s=0.01, hedge_delay_s=1e9,
                                 replica_cls=ProcReplica, replica_kwargs=rkw)
              for mode, (rkw, _) in plans.items()}
    res = {}
    try:
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                                 seed=1)
        model.eval()
        single = _fleet_factory(model, dev)()
        ids = [single.add_request(p, n) for p, n in specs]
        sdone = {r.request_id: r for r in single.run()}
        want = [sdone[i].tokens for i in ids]
        del single, model
        for mode, (_, plant) in plans.items():
            fleet = fleets[mode]
            for rep in fleet.replicas.values():
                fleet._warm(rep)
            with FaultInjector() as fi:
                plant(fi)
                fids = [fleet.submit(p, n) for p, n in specs]
                done = fleet.run()
            by = _delivered(f"proc_parity {mode}", fleet, done, fids)
            got = [by[f].tokens for f in fids]
            if got != want:
                raise AssertionError(f"[proc_parity] {mode}: f32 streams "
                                     f"differ at {_first_diff(got, want)[:4]}")
            if any(p.fired != p.times for p in fi.plans):
                raise AssertionError(f"[proc_parity] {mode}: {fi.plans}")
            g = fleet.gauges()
            rep0, rep1 = fleet.replicas[0], fleet.replicas[1]
            reg0 = rep0.engine.metrics
            want_kind = "breaker" if mode == "kill" else "wedge"
            if rep1.eject_kind != want_kind or rep0.respawns or rep0._hung \
                    or (mode == "kill"
                        and not reg0.counter("wire/errors").value) \
                    or (mode == "pause" and (g["breaker_open"]
                                             or rep1._proc.poll() is None)):
                raise AssertionError(f"[proc_parity] {mode}: {g}")
            _worker_launches(f"proc_parity {mode}", fleet, layers)
            res[mode] = {
                "eject": rep1.eject_kind,
                "wire_errors": reg0.counter("wire/errors").value,
                "rpc_retries": reg0.counter("proc/rpc_retries").value,
                "heartbeat_misses": rep1.engine.metrics.counter(
                    "proc/heartbeat_misses").value,
                "requeued": g["requeued"]}
            log(f"[proc_parity] {mode}: {len(fids)} f32 greedy streams "
                f"equal to the single engine's bit for bit, each fleet id "
                f"delivered once; {res[mode]}")
    finally:
        for fleet in fleets.values():
            fleet.close()
    log(f"[proc_parity] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return res


def _disagg_chunked(cfg, dev):
    """A 224-token prompt's pages from a prefill-role engine (bf16,
    FLEET_ENGINE's pages of 32) through a wire transport at the wire's
    8 MiB frame cap (``wire.MAX_FRAME``): the payload must go chunked,
    import whole into a decode-role engine and land there bit for bit;
    whether the decode engine's stream equals a colocated engine's is
    printed (bf16: they may part at a near tie)."""
    import threading

    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine, wire
    from paddle_tpu_torch.inference.disagg import (kv_payload_from_wire,
                                                   kv_payload_nbytes,
                                                   kv_payload_to_wire)
    from paddle_tpu_torch.models import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    model.eval()
    prompt = np.random.RandomState(45).randint(
        0, cfg.vocab_size, (DISAGG_CHUNKED_PROMPT,)).astype(np.int32)

    def eng(**kw):
        return ContinuousBatchingEngine(model, prefill_chunk=32, device=dev,
                                        **FLEET_ENGINE, **kw)
    colo = eng()
    colo.add_request(prompt, 16)
    want = colo.run()[-1].tokens
    pre, dec = eng(role="prefill"), eng(role="decode")
    pre.add_request(prompt, 16)
    for _ in range(64):
        pre.step()
        if pre.migrations_out:
            break
    (req, payload), = pre.take_migrations()
    a, b = wire.socketpair()
    ta = wire.WireTransport(a, side="worker", max_frame=wire.MAX_FRAME)
    tb = wire.WireTransport(b, side="worker", max_frame=wire.MAX_FRAME)
    t0 = time.perf_counter()
    try:
        sender = threading.Thread(
            target=ta.send, args=({"op": "kv_import",
                                   "payload": kv_payload_to_wire(payload)},))
        sender.start()
        got = tb.recv(120.0)
        sender.join()
    finally:
        ta.close()
        tb.close()
    ms = (time.perf_counter() - t0) * 1e3
    frames = got["seq"] + 1
    res = dec.import_migration(req, kv_payload_from_wire(got["payload"]))
    n = DISAGG_CHUNKED_PROMPT // FLEET_ENGINE["page_size"]
    if frames < 2 or res != {"imported": n, "dedup": 0, "rejected": 0}:
        raise AssertionError(f"[disagg] chunked payload: {frames} frames, "
                             f"{res}")
    node = dec._pc_root            # the seeded chain, root to leaf
    for lvl, blk in enumerate(payload["blocks"]):
        node = node.children[blk["tokens"].tobytes()]
        landed = dec._export_pages([node.page])[0]
        if any(x.tobytes() != y.tobytes()
               for x, y in zip(landed, blk["data"])):
            raise AssertionError(f"[disagg] chunked payload page {lvl} "
                                 f"landed with other bits")
    dec_stream = dec.run()[-1].tokens
    torch.cuda.synchronize()
    log(f"[disagg] a {DISAGG_CHUNKED_PROMPT}-token prompt's {n} pages "
        f"({kv_payload_nbytes(payload) / 1e6:.2f} MB of bf16 KV) went "
        f"through the wire in {frames} chunk frames in {ms:.1f} ms and "
        f"landed bit for bit; the decode engine's stream equals the "
        f"colocated engine's: {dec_stream == want}")
    del colo, pre, dec, model
    return {"frames": frames, "ms": ms, "equal": dec_stream == want}


def phase_disagg(cfg1b, layers=PROC_LAYERS, dev="cuda"):
    """bench.py:_cb_disagg_bench on the card: its traffic uncut
    (``build_trace_mix("long_prompt_flood", 128, seed=17)``) and role
    geometry at Llama-1B width, ``layers`` layers, bf16, seed 0: a
    ``DisaggServingFleet`` of 1 prefill and 1 decode worker process
    against 2 colocated workers (the bench's 2 + 2 against 4, cut for the
    time limit), each leg warmed as the bench warms it. Every request
    delivered, migrations above 0, no block rejected, no pin left on the
    source after the acks, launches a forward exact in every worker.
    While the workers boot: the chunked-wire check (``_disagg_chunked``),
    and at depth 2 in f32 the in-process disaggregated fleet's streams
    equal to the colocated engine's bit for bit, with f32 pools and with
    ``kv_quant="int8"`` (K13)."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import DisaggServingFleet, ProcReplica
    from paddle_tpu_torch.inference import ServingFleet
    t_phase = time.perf_counter()
    lh = _load_harness()
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    mix = lh.build_trace_mix("long_prompt_flood", DISAGG_REQUESTS,
                             vocab=cfg.vocab_size, seed=17)
    # the whole mix is submitted at once: a replica's queue holds it (the
    # default bound of 64 held it over the bench's 4 colocated replicas)
    repl_kw = dict(replica_cls=ProcReplica, replica_kwargs=dict(
        PROC_REPLICA, max_queue=DISAGG_REQUESTS))
    torch.cuda.empty_cache()
    colo = ServingFleet(_proc_spec(layers, "bfloat16", 0, dev,
                                   **DISAGG_ENGINE),
                        num_replicas=2, **repl_kw)
    fleet = DisaggServingFleet(
        _proc_spec(layers, "bfloat16", 0, dev,
                   **dict(DISAGG_ENGINE, **DISAGG_PREFILL)),
        num_prefill=1, num_decode=0, **repl_kw)
    try:
        fleet.scale_up(engine_factory=_proc_spec(
            layers, "bfloat16", 0, dev,
            **dict(DISAGG_ENGINE, **DISAGG_DECODE)),
            warm=False, role="decode")
        chunked = _disagg_chunked(cfg, dev)
        launches = _disagg_parity(cfg1b, mix[:DISAGG_PARITY_REQUESTS], dev)

        def run_leg(fl):
            for rep in fl.replicas.values():
                fl._warm(rep)
            for i in range(8):    # the bench's warm wave of long prompts
                fl.submit(((np.arange(40) + 97 * i)
                           % cfg.vocab_size).astype(np.int32), 12)
            fl.run()
            h = getattr(fl, "_h_migration", None)
            if h is not None:
                h.reset()
            g0 = fl.gauges()
            t0 = time.perf_counter()
            fids = [fl.submit(np.asarray(it["prompt"], np.int32),
                              int(it["max_new"])) for it in mix]
            done = fl.run()
            wall = time.perf_counter() - t0
            by = _delivered("disagg", fl, done, fids)
            streams = [by[f].tokens for f in fids]
            short = [(by[f].t_first - by[f].t_arrive) * 1e3
                     for f, it in zip(fids, mix) if it["kind"] == "short"]
            return streams, sum(map(len, streams)) / wall, _p99(short), g0

        colo_streams, colo_tps, colo_p99, _ = run_leg(colo)
        for k, v in _worker_launches("disagg colocated", colo,
                                     layers).items():
            launches[k] = launches.get(k, 0) + v
        colo.close()
        streams, tps, p99, g0 = run_leg(fleet)
        g = fleet.gauges()
        moved = g["migrations"] - g0["migrations"]
        pre, dec = fleet.replicas[0], fleet.replicas[1]
        pages = pre.engine.metrics.counter("disagg/kv_pages_exported").value
        rejects = dec.engine.metrics.counter(
            "disagg/kv_import_crc_rejects").value
        if moved <= 0 or rejects or g["migration_failures"]:
            raise AssertionError(f"[disagg] {moved} migrations, {rejects} "
                                 f"blocks rejected, "
                                 f"{g['migration_failures']} failures")
        for k, v in _worker_launches("disagg", fleet, layers).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        colo.close()
        fleet.close()
    same = sum(a == b for a, b in zip(streams, colo_streams))
    out = {"cb_disagg_tok_s": round(tps, 2),
           "cb_disagg_p99_ttft_ms": round(p99, 2),
           "cb_disagg_colocated_p99_ttft_ms": round(colo_p99, 2),
           "cb_disagg_migration_ms_p99": round(g["migration_ms_p99"], 2),
           "cb_disagg_vs_colocated": round(tps / colo_tps, 4)}
    log(f"[disagg] {len(mix)} long_prompt_flood requests, 1 prefill + 1 "
        f"decode worker ({layers} layers bf16) against 2 colocated: "
        f"{moved} migrations, {pages} pages and "
        f"{g['kv_bytes_moved'] / 1e6:.2f} MB of KV moved (the warm wave's "
        f"included), no block rejected, no pin left; colocated "
        f"{colo_tps:.1f} tok/s; {json.dumps(out)}")
    log(f"[disagg] launches {launches} ({2 * layers + 1}/{layers}/{layers}"
        f" a forward, exact in each "
        f"worker and each in-process fleet); bf16 streams equal to the "
        f"colocated fleet's: {same}/{len(mix)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return dict(out, launches=launches, chunked=chunked)


def _disagg_parity(cfg1b, mix, dev, layers=2):
    """At depth ``layers`` in f32 (seed 1), in process: the disaggregated
    fleet's streams of ``mix`` equal the colocated engine's bit for bit
    with f32 pools and with int8 pools (K13); launches a forward exact.
    Returns the launches."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            DisaggServingFleet)
    from paddle_tpu_torch.models import LlamaForCausalLM
    model = LlamaForCausalLM(dataclasses.replace(
        cfg1b, num_hidden_layers=layers), device=dev, dtype=torch.float32,
        seed=1)
    model.eval()
    launches, moved = {}, {}
    for kvq in ("none", "int8"):
        def make(role="both", kvq=kvq):
            return ContinuousBatchingEngine(model, device=dev, kv_quant=kvq,
                                            audit=True, role=role,
                                            **DISAGG_ENGINE)
        ref = make()
        ids = [ref.add_request(np.asarray(it["prompt"], np.int32),
                               int(it["max_new"])) for it in mix]
        rby = {r.request_id: r for r in ref.run()}
        want = [rby[i].tokens for i in ids]
        wrappers = _counted(SERVE_KERNELS + ("ragged_paged_attention_quant",))
        engines = []

        def counted(role="both", make=make):
            eng = make(role)
            engines.append(eng)
            return eng
        # no hedges: a copy's race would make the replicas' work depend
        # on the host's timing
        fleet = DisaggServingFleet(counted, num_prefill=1, num_decode=1,
                                   hedge_delay_s=1e9,
                                   max_queue=DISAGG_REQUESTS)
        fids = [fleet.submit(np.asarray(it["prompt"], np.int32),
                             int(it["max_new"])) for it in mix]
        by = _delivered(f"disagg {kvq}", fleet, fleet.run(), fids)
        got = [by[f].tokens for f in fids]
        if got != want:
            raise AssertionError(f"[disagg] f32 {kvq} pools: streams differ "
                                 f"at {_first_diff(got, want)[:4]}")
        if any(eng._exported_pins for eng in engines):
            raise AssertionError(f"[disagg] {kvq}: exported pins left")
        torch.cuda.synchronize()
        n = {k: w.launches for k, w in wrappers.items()}
        _launch_check(f"disagg {kvq}", n,
                      sum(e._stats["forwards"] for e in engines), layers,
                      attn="ragged_paged_attention" if kvq == "none"
                      else "ragged_paged_attention_quant")
        moved[kvq] = fleet.gauges()["migrations"]
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    log(f"[disagg] depth {layers} f32: the disaggregated fleet's "
        f"{len(mix)} streams equal the colocated engine's bit for bit with "
        f"f32 pools ({moved['none']} migrations) and int8 pools "
        f"({moved['int8']}; K13 {launches['ragged_paged_attention_quant']}"
        f" launches)")
    return launches


def phase_autoscale(cfg1b, layers=PROC_LAYERS, dev="cuda"):
    """bench.py:_cb_autoscale_bench's flash_crowd leg on the card: an
    in-process fleet of Llama-1B engines (``layers`` layers, bf16, one
    shared model, seed 0) with a ``FleetAutoscaler`` for 1 to 3 replicas
    over the load harness's ``flash_crowd`` schedule (seed 23, 2 fleet
    turns a tick, hysteresis on its ``TickClock``), against 3 fixed
    replicas. The scenario's attainment bar, no request lost, a scale-up
    within ``AUTOSCALE_ONSET_TICKS`` of onset, fewer chip-seconds than
    the fixed fleet, every applied action in /statusz, launches a
    forward exact."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            FleetAutoscaler, Overloaded,
                                            ServingFleet)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.profiler.slo import SLORule
    t_phase = time.perf_counter()
    lh = _load_harness()
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    model.eval()
    sc = lh.SCENARIOS["flash_crowd"]
    schedule = lh.build_scenario("flash_crowd", vocab=cfg.vocab_size,
                                 seed=AUTOSCALE_SEED)
    engines = []

    def factory():
        eng = ContinuousBatchingEngine(model, device=dev, audit=True,
                                       **AUTOSCALE_ENGINE)
        engines.append(eng)
        return eng

    def leg(n, ctl_kw):
        fleet = ServingFleet(factory, n, slo_rules=[
            SLORule(**d) for d in sc["slo_rules"]], hedge_delay_s=None,
            seed=0)
        clock = lh.TickClock()
        ctl = FleetAutoscaler(fleet, now_fn=clock, **ctl_kw) \
            if ctl_kw else None
        t0 = time.perf_counter()
        report = lh.run_fleet_scenario(
            fleet, schedule, autoscaler=ctl, clock=clock,
            shed_exc=Overloaded, steps_per_tick=AUTOSCALE_STEPS_PER_TICK)
        report["seconds"] = time.perf_counter() - t0
        fleet.close()
        lost = report["accepted"] - report["completed_ok"]
        if report["failed"] or lost:
            raise AssertionError(f"[autoscale] {lost} lost, "
                                 f"{report['failed']} failed: {report}")
        return fleet, ctl, clock, report

    _, _, fclock, fixed = leg(AUTOSCALE_CTL["max_replicas"], None)
    fixed_chip_s = AUTOSCALE_CTL["max_replicas"] * fclock.t
    engines.clear()
    wrappers = _counted(SERVE_KERNELS)
    fleet, ctl, clock, rep = leg(1, AUTOSCALE_CTL)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    # the scale-ups' warm-up forwards, which their gauge resets zero in
    # the engines, stand in the fleet's own count
    _launch_check("autoscale", launches, fleet.metrics.counter(
        "fleet/warmup_forwards").value + sum(e._stats["forwards"]
                                             for e in engines), layers)
    attain = rep["slo"]["worst_attainment"]
    ups = [a for a in ctl.actions() if a["action"] == "scale_up"]
    downs = [a for a in ctl.actions() if a["action"] == "scale_down"]
    logged = {(d["tick"], d["action"])
              for d in fleet.statusz()["autoscaler"]["decisions"]}
    if attain < sc["attainment_bar"] or not ups \
            or ups[0]["tick"] > sc["window"][0] + AUTOSCALE_ONSET_TICKS \
            or rep["chip_seconds"] >= fixed_chip_s \
            or any((a["tick"], a["action"]) not in logged
                   for a in ctl.actions()):
        raise AssertionError(f"[autoscale] attainment {attain} (bar "
                             f"{sc['attainment_bar']}), ups {ups[:2]}, "
                             f"chip-s {rep['chip_seconds']} against "
                             f"{fixed_chip_s}")
    out = {"autoscale_goodput_frac": rep["goodput_frac"],
           "autoscale_slo_attainment": round(attain, 4),
           "autoscale_chip_seconds": rep["chip_seconds"],
           "autoscale_decisions": int(
               fleet.metrics.counter("autoscale/decisions").value),
           "autoscale_vs_fixed_chips": round(rep["chip_seconds"]
                                             / fixed_chip_s, 4)}
    log(f"[autoscale] flash_crowd ({rep['submitted']} requests, "
        f"{rep['ticks']} ticks, {rep['seconds']:.1f} s): first scale-up "
        f"at tick {ups[0]['tick']} (onset {sc['window'][0]}), "
        f"{len(ups)} up / {len(downs)} down, peak {rep['peak_ready']} "
        f"ready, p99 TTFT {rep['ttft_ms_p99']} ms; fixed 3 replicas: "
        f"goodput {fixed['goodput_frac']}, attainment "
        f"{fixed['slo']['worst_attainment']:.4f}, {fixed_chip_s:.1f} "
        f"chip-s in {fixed['seconds']:.1f} s; {json.dumps(out)}")
    log(f"[autoscale] launches {launches} ({2 * layers + 1}/{layers}/"
        f"{layers} a forward, exact); every "
        f"applied action in /statusz; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del fleet, engines, model
    torch.cuda.empty_cache()
    return dict(out, launches=launches)


#: the HTTP phase's repetitions: the bench takes the best of 2, but two
#: legs of each kind (about 190 s on the card) would take the script past
#: its budget, so it runs one of each
HTTP_REPS = 1
#: the HTTP phase's requests: the bench's 64 at concurrency 24 took about
#: 90 s of the script's time limit; 16 (24 until the pipeline's cases
#: came in) all at once, twice the engine's 8 slots
HTTP_REQUESTS = 16
#: the warm-up's requests, drawn apart from the timed ones
HTTP_WARM_REQUESTS = 8


def phase_http(model, reps=HTTP_REPS, dev="cuda"):
    """The JAX bench's HTTP section (bench.py:_cb_http_bench) on the
    port: an engine-backed ``ApiServer`` over Llama-1B bf16 (8 slots,
    page 32, decode chunk 32, max_len 384, prompt buckets (8, 16), SSE
    chunks of 32 tokens), warmed on ``HTTP_WARM_REQUESTS`` requests of
    their own, driven by tools/load_harness.py as a separate
    process with the bench's flags but ``HTTP_REQUESTS`` requests (its
    64) at once (its concurrency 24), closed
    loop, prompts of 3-5 tokens, 128-192 new, a quarter sharing a
    4-token prefix, two tenants, seed 44), best of ``reps`` (the bench's
    2; ``HTTP_REPS``) interleaved with the same requests pushed straight
    into an identically configured engine. Every request must complete without an error; a
    unary completion must return the engine's own greedy tokens;
    /v1/models, /healthz and /statusz must answer 200; a request while
    the admission queue is full must get 429 with a Retry-After."""
    import tempfile
    import urllib.error
    import urllib.request

    import torch
    from paddle_tpu_torch.inference import (AdmissionController, ApiServer,
                                            ContinuousBatchingEngine)
    cfg = model.config
    n_req, new_lo, new_hi, sse_chunk = HTTP_REQUESTS, 128, 192, 32
    conc = min(24, n_req)

    def factory():
        return ContinuousBatchingEngine(
            model, num_slots=8, page_size=32, max_len=384, decode_chunk=32,
            prompt_buckets=(8, 16), greedy=True, device=dev)

    def draw(seed, n):
        rng = np.random.RandomState(seed)
        return [(rng.randint(0, cfg.vocab_size, (int(rng.randint(3, 6)),))
                 .astype(np.int32), int(rng.randint(new_lo, new_hi + 1)))
                for _ in range(n)]

    specs = draw(44, n_req)
    warm_specs = draw(45, HTTP_WARM_REQUESTS)  # not the timed requests

    def warm(eng):
        for p, n in warm_specs:
            eng.add_request(p, n)
        eng.run()

    direct, served = factory(), factory()
    warm(direct)
    warm(served)
    srv = ApiServer(served, stream_chunk_tokens=sse_chunk).start()
    harness = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "load_harness.py")

    def direct_once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, n in specs:
            direct.add_request(p, n)
        done = direct.run()
        torch.cuda.synchronize()
        return sum(len(r.tokens) for r in done) / (time.perf_counter() - t0)

    def http_once():
        with tempfile.TemporaryDirectory() as tmp:
            rep_path = os.path.join(tmp, "report.json")
            proc = subprocess.run(
                [sys.executable, harness, "--url", srv.url,
                 "--requests", str(n_req), "--concurrency", str(conc),
                 "--mode", "closed", "--vocab", str(cfg.vocab_size),
                 "--prompt-len", "3", "5",
                 "--max-new", str(new_lo), str(new_hi),
                 "--prefix-frac", "0.25", "--prefix-len", "4",
                 "--tenants", "tenant0,tenant1", "--seed", "44",
                 "--report", rep_path],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"[http] load harness failed "
                                     f"({proc.returncode}): "
                                     f"{proc.stderr[-800:]}")
            with open(rep_path) as f:
                report = json.load(f)
        if report["completed_ok"] != report["requests"] or report["errors"]:
            raise AssertionError(f"[http] {report['completed_ok']}/"
                                 f"{report['requests']} ok, errors "
                                 f"{report['errors']}")
        return report

    if reps != 2:
        log(f"[http] {reps} rep(s) of each leg, not the bench's 2: the "
            f"script's time limit forces it")
    launches = {k: 0 for k in SERVE_KERNELS}
    forwards = 0
    try:
        direct_tps, best, reports = 0.0, None, []
        for _ in range(reps):
            direct_tps = max(direct_tps, direct_once())
            wrappers = _counted(SERVE_KERNELS)
            f0 = served._stats["forwards"]
            rep = http_once()
            torch.cuda.synchronize()
            forwards += served._stats["forwards"] - f0
            for k, w in wrappers.items():
                launches[k] += w.launches
            reports.append(rep)
            if best is None or rep["tok_s"] > best["tok_s"]:
                best = rep
        _launch_check("http", launches, forwards, cfg.num_hidden_layers)
        # a unary completion returns the engine's own greedy tokens
        prompt, n_new = specs[1]
        direct.add_request(prompt, n_new)
        want = " ".join(str(t) for t in direct.run()[-1].tokens)
        req = urllib.request.Request(
            srv.url + "/v1/completions",
            data=json.dumps({"prompt": [int(t) for t in prompt],
                             "max_tokens": n_new}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            doc = json.loads(r.read())
        if doc["choices"][0]["text"] != want:
            raise AssertionError(f"[http] unary completion "
                                 f"{doc['choices'][0]['text']!r} != the "
                                 f"engine's {want!r}")
        for path in ("/v1/models", "/healthz", "/statusz"):
            with urllib.request.urlopen(srv.url + path, timeout=60) as r:
                if r.status != 200:
                    raise AssertionError(f"[http] {path} {r.status}")
    finally:
        srv.stop()
    # the admission queue full: 429 with a Retry-After
    shed = ApiServer(AdmissionController(direct, max_queue=0,
                                         min_retry_after_s=2.0)).start()
    try:
        req = urllib.request.Request(
            shed.url + "/v1/completions",
            data=json.dumps({"prompt": [1, 2], "max_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            raise AssertionError("[http] no 429 with the queue full")
        except urllib.error.HTTPError as e:
            retry_after = e.headers.get("Retry-After")
            if e.code != 429 or not retry_after or int(retry_after) < 2:
                raise AssertionError(f"[http] {e.code}, Retry-After "
                                     f"{retry_after}") from None
    finally:
        shed.stop()
    out = {"cb_http_tok_s": round(best["tok_s"], 2),
           "cb_http_p99_ttft_ms": round(best["ttft_ms_p99"], 2),
           "cb_http_goodput_frac": round(best["goodput_frac"], 4),
           "cb_http_vs_engine": round(best["tok_s"] / direct_tps, 4)}
    log(f"[http] {n_req} SSE streams x{conc} concurrent through the front "
        f"door, best of {reps} interleaved with the direct engine "
        f"({direct_tps:.1f} tok/s): {json.dumps(out)}; reps "
        f"{[round(r['tok_s'], 1) for r in reports]} tok/s; "
        f"{best['completed_ok']}/{best['requests']} ok, no errors")
    log(f"[http] the unary completion equals the engine's {n_new} greedy "
        f"tokens; /v1/models, /healthz, /statusz 200; queue full -> 429 "
        f"Retry-After {retry_after}; launches {launches} over {forwards} "
        f"forwards of the served engine")
    del direct, served
    torch.cuda.empty_cache()
    return dict(out, launches=launches)


#: a Prometheus sample line: ``name{labels} value``
PROM_LINE = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? (\S+)$")


def _prom_parses(text):
    """The Prometheus text exposition parses: every sample line is
    ``name{labels} value`` with a numeric value, one TYPE a family."""
    types = []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            types.append(line.split()[2])
        elif line and not line.startswith("#"):
            m = PROM_LINE.match(line)
            if not m:
                raise AssertionError(f"[observability] unparseable "
                                     f"/metrics line {line!r}")
            float(m.group(2))
    if not text.endswith("\n") or len(types) != len(set(types)):
        raise AssertionError("[observability] /metrics: torn text or a "
                             "family typed twice")


def phase_observability(cfg1b, layers=2, dev="cuda"):
    """The fleet's observability on a fresh fleet of 3 replicas at
    Llama-1B's width and depth 2 in bf16 (the fleet phase's geometry),
    warmed, then the flight recorder installed with a 2 s watchdog:

    - 24 requests while /metrics and /statusz are scraped from two
      threads through ``fleet.observability_server()``: every scrape
      parses, the text carries the fleet's families and the replicas'
      with a ``replica`` label, every /statusz section evaluates without
      an ``error`` stanza, and the watchdog dumps nothing;
    - a dispatch and its successor with the tracer on and the recorder
      installed, under ``torch.cuda.set_sync_debug_mode("error")``;
    - ``wedge_replica(0)``: the no-progress check ejects replica 0 and
      its requests are delivered by its siblings; the heartbeats went on,
      so the watchdog dumps nothing, and the post-mortem bundle
      (``rec.dump``) is complete: the ejection in its ring, every
      thread's stack, the federated metrics with replica labels;
    - ``slow_replica(1)`` blocking one step for 3 s: the watchdog dumps
      one stall bundle naming the fleet's run loop, and every request is
      delivered."""
    import dataclasses
    import tempfile
    import threading
    import urllib.request

    import torch
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.profiler import flight_recorder as fr
    from paddle_tpu_torch.profiler.slo import SLORule
    from paddle_tpu_torch.profiler.trace import get_tracer
    from paddle_tpu_torch.testing import FaultInjector
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=1)
    model.eval()
    factory = _fleet_factory(model, dev)
    fleet = ServingFleet(factory, num_replicas=3, max_restarts=1,
                         retry_backoff_s=0.01, slo_rules=[
                             SLORule("ttft", kind="ttft",
                                     threshold_ms=60_000, target=0.9,
                                     min_events=5)])
    for rep in fleet.replicas.values():
        fleet._warm(rep)
    tmp = tempfile.mkdtemp(prefix="flight_")
    # bundles carry the fleet's federated metrics, in a run or after it
    rec = fr.install(capacity=4096, bundle_dir=tmp, registry=fleet.metrics,
                     watchdog_timeout_s=2.0)
    wd = fr.get_watchdog()
    rng = np.random.RandomState(46)
    launches = {k: 0 for k in SERVE_KERNELS}
    forwards = 0

    def serve(n, tag):
        nonlocal forwards
        engines = [r.engine for r in fleet.replicas.values() if r.live()]
        f0 = sum(e._stats["forwards"] for e in engines)
        wrappers = _counted(SERVE_KERNELS)
        fids = [fleet.submit(rng.randint(0, cfg.vocab_size,
                                         int(rng.randint(48, 193))),
                             int(rng.randint(16, 49)),
                             tenant=f"tenant{i % 2}") for i in range(n)]
        done = fleet.run()
        torch.cuda.synchronize()
        for k, w in wrappers.items():
            launches[k] += w.launches
        forwards += sum(e._stats["forwards"] for e in engines) - f0
        return _delivered(f"observability {tag}", fleet, done, fids)

    srv = fleet.observability_server()
    stop = threading.Event()
    bodies = {"/metrics": [], "/statusz": []}
    errors = []

    def scraper(path):
        while not stop.is_set():
            try:
                with urllib.request.urlopen(srv.url + path,
                                            timeout=30) as r:
                    bodies[path].append(r.read().decode())
            except Exception as e:  # noqa: BLE001 — the phase's failure
                errors.append(repr(e))
            time.sleep(0.05)

    threads = [threading.Thread(target=scraper, args=(p,), daemon=True)
               for p in bodies]
    try:
        for t in threads:
            t.start()
        serve(24, "scraped")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    if errors or not all(bodies.values()):
        raise AssertionError(f"[observability] scrapes: {errors[:3]}, "
                             f"{[len(b) for b in bodies.values()]}")
    final = srv.render_metrics()
    srv.stop()
    for text in bodies["/metrics"] + [final]:
        _prom_parses(text)
    for family in ("paddle_fleet_completed", "paddle_fleet_submitted",
                   'paddle_serving_tokens_emitted{replica="0"}',
                   'paddle_serving_prefix_cache_pages{replica="2"}',
                   'paddle_serving_ttft_ms{quantile="0.99"}',
                   'paddle_slo_attainment{rule="ttft",tenant="tenant0"}'):
        if family not in final:
            raise AssertionError(f"[observability] /metrics lacks "
                                 f"{family}")
    for body in bodies["/statusz"]:
        doc = json.loads(body)
        bad = {k: v for k, v in doc.items()
               if isinstance(v, dict) and set(v) == {"error"}}
        if bad or not {"fleet", "replicas", "slo", "slowest_traces",
                       "flight_recorder", "goodput"} <= set(doc):
            raise AssertionError(f"[observability] /statusz {bad or doc}")
    if rec.dumps or wd.stall_dumps:
        raise AssertionError(f"[observability] an uninjected run dumped "
                             f"{rec.dumps} bundles")
    log(f"[observability] {len(bodies['/metrics'])} /metrics and "
        f"{len(bodies['/statusz'])} /statusz scrapes during 24 requests: "
        f"all parse, replica-labelled families present, every section "
        f"evaluates; fleet obs overhead "
        f"{fleet.gauges()['obs_overhead_frac']:.5f}; no bundle dumped")
    # the dispatch stays sync-free with the tracer on and the recorder in
    eng = factory()
    eng.add_request(np.arange(64) % cfg.vocab_size, 4)
    eng.run()
    for n in (40, 9):
        eng.add_request(rng.randint(0, cfg.vocab_size, n), 6)
    eng._admit()
    tracer = get_tracer()
    tracer.enabled = True
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = eng._dispatch_step()
        second = eng._dispatch_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        tracer.enabled = False
        tracer.clear()
    eng._harvest_step(first)
    eng._harvest_step(second)
    if sorted(len(r.tokens) for r in eng.run()) != [6, 6]:
        raise AssertionError("[observability] sync-debug streams")
    kinds = [e["kind"] for e in rec.events()]
    if kinds.count("sched_turn") < 2 or "admit" not in kinds or rec.dumps:
        raise AssertionError(f"[observability] the recorder's ring after "
                             f"the sync-debug dispatches: {kinds[-8:]}, "
                             f"{rec.dumps} dumps")
    del eng
    log("[observability] two dispatches with the tracer on (trace sample "
        "rate 0.01) and the recorder installed made no host "
        "synchronisation under set_sync_debug_mode('error')")
    # a wedged replica: ejected by the no-progress check
    with FaultInjector() as fi:
        fi.wedge_replica(0)
        by = serve(24, "wedge")
    g = fleet.gauges()
    # the requests routed to the wedged replica, each finished elsewhere
    rescued = [f for f, r in by.items()
               if any(h["kind"] == "assign" and h.get("replica") == 0
                      for h in r.hops)]
    if fleet.replicas[0].eject_kind != "wedge" or g["wedge_ejections"] != 1 \
            or not rescued or any(
                [h for h in by[f].hops if h["kind"] == "finish"][-1].get(
                    "replica") == 0 for f in rescued):
        raise AssertionError(f"[observability] wedge: {g}, {rescued}")
    if rec.dumps or wd.stall_dumps:
        raise AssertionError("[observability] the wedge's heartbeats went "
                             "on, yet the watchdog dumped")
    path = rec.dump("post-mortem: replica 0 wedged and ejected")
    doc = json.load(open(path))
    kinds = [e["kind"] for e in doc["events"]]
    if doc["schema"] != fr.BUNDLE_SCHEMA or not any(
            e["kind"] == "fleet_eject" and e.get("cause") == "wedge"
            for e in doc["events"]) or "sched_turn" not in kinds \
            or not doc["threads"] or not any(
                k.startswith("serving/tokens_emitted{replica=")
                for k in doc["metrics"]):
        raise AssertionError(f"[observability] incomplete bundle: "
                             f"{sorted(doc)}, {kinds[-5:]}")
    log(f"[observability] wedge_replica(0): ejected by the no-progress "
        f"check, {len(rescued)} of its requests delivered by its siblings, "
        f"no liveness dump (heartbeats went on); the post-mortem bundle "
        f"holds {len(doc['events'])} ring events with the ejection, "
        f"{len(doc['threads'])} thread stacks and "
        f"{len(doc['metrics'])} federated metrics")
    # a hung step: the watchdog dumps one stall bundle
    with FaultInjector() as fi:
        fi.slow_replica(1, delay_s=3.0, stride=1, times=1)
        serve(8, "hang")
    stalls = rec.incidents()
    if wd.stall_dumps != 1 or not stalls:
        raise AssertionError(f"[observability] hang: {wd.stall_dumps} "
                             f"stall dumps, incidents {stalls}")
    stall = json.load(open(os.path.join(tmp, stalls[-1])))
    if "fleet run loop" not in stall["reason"] or not stall["events"] \
            or not stall["threads"]:
        raise AssertionError(f"[observability] stall bundle "
                             f"{stall['reason']}")
    log(f"[observability] a 3 s hang in replica 1's step: the watchdog "
        f"dumped one stall bundle ({stall['reason']}); every request "
        f"delivered; launches {launches} over {forwards} forwards")
    _launch_check("observability", launches, forwards, layers)
    fr.uninstall()
    del fleet, model
    torch.cuda.empty_cache()
    return dict(launches=launches)


#: phase spec's new tokens a request (the bench's 96, cut for the
#: script's time limit)
SPEC_NEW = 32


def phase_spec(model, dev="cuda"):
    """Speculative decoding on Llama-1B (bf16, full width, 4 layers) with
    the JAX bench's TPU configuration (bench.py:_cb_spec_bench): page 32,
    max_len 384, prefill chunk 64, decode chunk 1 for both legs, spec_k
    4, n-gram drafts; prompts of 16 seeded random tokens tiled 3 times,
    ``SPEC_NEW`` new tokens each (the bench's 96, cut for the script's
    time limit); batches of 1, 4 and 8 slots (as many requests),
    one warm-up run then 2 timed ones for each leg. The greedy spec
    streams must equal the plain engine's (both legs run [B, 64]
    forwards only, so K12 sums every row in one order). Launches are
    counted over the A/B. Then, at batch 1: self-speculative drafts,
    oracle drafts (the plain stream: accept rate exactly 1.0) and
    adversarial ones (the oracle + 1: exactly 0.0), and at batch 4 int8
    pools against int8 plain, each with the plain stream."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.spec_decode import draft_skip_layers
    from paddle_tpu_torch.testing import OracleDraftSource
    cfg = model.config
    vocab = cfg.vocab_size
    page, max_len, chunk, k = 32, 384, 64, 4
    base_len, tile, n_new, reps = 16, 3, SPEC_NEW, 2

    def make(slots, spec, **kw):
        if spec:
            kw = dict(spec_k=k, spec_draft="ngram") | kw
        return ContinuousBatchingEngine(
            model, num_slots=slots, page_size=page, max_len=max_len,
            decode_chunk=1, prefill_chunk=chunk, greedy=True, audit=True,
            device=dev, **kw)

    def prompts_for(nreq, seed):
        rng = np.random.RandomState(seed)
        return [np.tile(rng.randint(0, vocab, (base_len,)).astype(np.int32),
                        tile) for _ in range(nreq)]

    def erun(eng, prompts):
        ids = [eng.add_request(p, n_new) for p in prompts]
        by = {r.request_id: r for r in eng.run()}
        if sorted(by) != sorted(ids) or any(
                by[i].error is not None or len(by[i].tokens) != n_new
                for i in ids):
            raise AssertionError("[spec] a request did not complete")
        _drain_check("spec", eng)
        return [by[i].tokens for i in ids]

    def timed(eng, nreq, seed0):
        erun(eng, prompts_for(nreq, 900))            # warm-up
        fw = eng._stats["forwards"]
        eng.reset_gauges()
        best, streams = 0.0, []
        for i in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streams.append(erun(eng, prompts_for(nreq, seed0 + i)))
            best = max(best, nreq * n_new / (time.perf_counter() - t0))
        return best, streams, eng.gauges(), fw + eng._stats["forwards"]

    wrappers = _counted(SERVE_KERNELS)
    forwards = 0
    batches, ref = {}, {}
    for b in (1, 4, 8):
        p_tps, p_streams, p_g, p_fw = timed(make(b, False), b, 910 + b)
        s_tps, s_streams, s_g, s_fw = timed(make(b, True), b, 910 + b)
        forwards += p_fw + s_fw
        if s_streams != p_streams:
            diff = [_first_diff(s, p) for s, p in zip(s_streams, p_streams)]
            raise AssertionError(f"[spec] b{b}: spec streams differ from "
                                 f"the plain engine's at (stream, token) "
                                 f"{diff} (one list a timed run)")
        ref[b] = p_streams[0]
        batches[f"b{b}"] = dict(
            tok_s=s_tps, plain_tok_s=p_tps, vs_plain=s_tps / p_tps,
            accept_rate=s_g["spec_accept_rate"],
            itl_ms_p99=s_g["itl_ms_p99"], plain_itl_ms_p99=p_g["itl_ms_p99"],
            steps=s_g["unified_steps"], plain_steps=p_g["unified_steps"],
            drafted=s_g["spec_tokens_drafted"],
            accepted=s_g["spec_tokens_accepted"])
        bb = batches[f"b{b}"]
        log(f"[spec] b{b}: {b} requests x {n_new} new, spec {s_tps:.1f} "
            f"tok/s against plain {p_tps:.1f} (spec/plain "
            f"{bb['vs_plain']:.4f}), accept rate {bb['accept_rate']:.4f} "
            f"({bb['accepted']}/{bb['drafted']} drafts), ITL p99 "
            f"{bb['itl_ms_p99']:.2f} ms against {bb['plain_itl_ms_p99']:.2f}"
            f", steps {bb['steps']} against {bb['plain_steps']} (the 2 "
            f"timed runs); greedy streams identical")
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    _launch_check("spec", launches, forwards, cfg.num_hidden_layers)
    log(f"[spec] launches over the A/B {launches} ({forwards} forwards)")
    res = dict(launches=launches, batches=batches)

    p1 = prompts_for(1, 911)
    eng = make(1, True, spec_draft="self")
    L = cfg.num_hidden_layers
    skip = draft_skip_layers(cfg)
    wrappers = _counted(SERVE_KERNELS)
    got = erun(eng, p1)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    _launch_check("spec self", launches, eng._stats["forwards"], L,
                  draft_forwards=eng._stats["draft_forwards"],
                  draft_layers=L - len(skip))
    res["launches_self"] = launches
    g = eng.gauges()
    if got != ref[1]:
        raise AssertionError(f"[spec] self-speculative stream differs from "
                             f"the plain one at {_first_diff(got, ref[1])}")
    res["self_accept_rate"] = g["spec_accept_rate"]
    log(f"[spec] self-speculative drafts (layers {skip[0]}-{skip[-1]} "
        f"skipped), b1: accept rate {g['spec_accept_rate']:.4f} "
        f"({g['spec_tokens_accepted']}/{g['spec_tokens_drafted']}), "
        f"{g['unified_steps']} steps, {eng._stats['forwards']} verify "
        f"forwards and {eng._stats['draft_forwards']} draft forwards; "
        f"stream identical to the plain engine's; launches {launches}")
    for name, shift, rate in (("oracle", 0, 1.0), ("adversarial", 1, 0.0)):
        eng = make(1, True, spec_draft=OracleDraftSource(
            dict(enumerate(ref[1])), vocab, shift))
        got = erun(eng, p1)
        g = eng.gauges()
        if got != ref[1] or g["spec_accept_rate"] != rate \
                or not g["spec_tokens_drafted"]:
            raise AssertionError(f"[spec] {name} drafts: accept rate "
                                 f"{g['spec_accept_rate']} (want {rate}), "
                                 f"streams equal {got == ref[1]}")
        log(f"[spec] {name} drafts, b1: accept rate "
            f"{g['spec_accept_rate']:.4f} exactly ({g['spec_tokens_drafted']}"
            f" drafted), {g['unified_steps']} steps; stream identical")
    p4 = prompts_for(4, 914)
    plain8 = erun(make(4, False, kv_quant="int8"), p4)
    eng = make(4, True, kv_quant="int8")
    quant = SERVE_KERNELS + ("ragged_paged_attention_quant",)
    wrappers = _counted(quant)
    spec8 = erun(eng, p4)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    _launch_check("spec int8", launches, eng._stats["forwards"], L,
                  attn="ragged_paged_attention_quant")
    res["launches_int8"] = launches
    if spec8 != plain8:
        raise AssertionError(f"[spec] int8 pools: spec streams differ from "
                             f"int8 plain at {_first_diff(spec8, plain8)}")
    log(f"[spec] int8 pools, b4: spec streams identical to int8 plain, "
        f"accept rate {eng.gauges()['spec_accept_rate']:.4f}, "
        f"{eng._stats['forwards']} forwards; launches {launches}")
    del eng
    torch.cuda.empty_cache()
    return res


def phase_spec_8b(model, serve_streams, dev="cuda"):
    """Speculative decoding at Llama-3-8B's full width (rep 4), serve's
    model:
    the first 4 of the serve phase's requests, 32 new tokens each, in the
    serve phase's geometry with decode chunk 1. n-gram and oracle spec
    streams must equal the plain engine's; the share of them equal to
    the serve phase's streams (decode chunk 8, whose [B, 1] decode
    forwards take K12's other warp layout and cuBLAS's other shapes) is
    printed, not required."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.testing import OracleDraftSource
    vocab = model.config.vocab_size
    _, prompts = _serve_traffic(vocab)
    prompts, n_new = prompts[:4], 32

    def make(**kw):
        return ContinuousBatchingEngine(
            model, num_slots=8, page_size=16, max_len=2048,
            prefill_chunk=256, decode_chunk=1, prefix_cache=False,
            audit=True, device=dev, **kw)

    streams = {}
    for name in ("plain", "ngram", "oracle"):
        if name == "plain":
            eng = make()
        else:
            eng = make(spec_k=4, spec_draft=name if name == "ngram" else
                       OracleDraftSource(dict(enumerate(streams["plain"])),
                                         vocab))
        ids = [eng.add_request(p, n_new) for p in prompts]
        t0 = time.perf_counter()
        by = {r.request_id: r.tokens for r in eng.run()}
        wall = time.perf_counter() - t0
        _drain_check("spec_8b", eng)
        streams[name] = [by[i] for i in ids]
        g = eng.gauges()
        log(f"[spec_8b] {name}: 4 requests x {n_new} new in {wall:.2f} s, "
            f"{g['unified_steps']} steps"
            + (f", accept rate {g['spec_accept_rate']:.4f}" if name != "plain"
               else ""))
        if name == "oracle" and g["spec_accept_rate"] != 1.0:
            raise AssertionError(f"[spec_8b] oracle accept rate "
                                 f"{g['spec_accept_rate']}")
        if name != "plain" and streams[name] != streams["plain"]:
            raise AssertionError(
                f"[spec_8b] {name} streams differ from plain at "
                f"{_first_diff(streams[name], streams['plain'])}")
        del eng
    serve4 = serve_streams[:4]
    same = sum(a == b for a, b in zip(streams["plain"], serve4))
    log(f"[spec_8b] n-gram and oracle spec streams identical to plain at "
        f"decode chunk 1; {same}/4 equal the serve phase's decode-chunk-8 "
        f"streams (first divergences (stream, token): "
        f"{_first_diff(streams['plain'], serve4)})")
    torch.cuda.empty_cache()
    return dict(equal_to_serve=same / 4)


WOL_ALGOS = ("weight_only_int8", "weight_only_int4")


def phase_weight_quant(cfg, serve_streams, dev="cuda", n_tokens=1500):
    """Weight-only quantization of the serve phase's Llama-3-8B (seed 0,
    bf16, full width, serve's depth), built anew and converted to int8, then
    again to int4 (``quantize_for_serving``): the layers, bytes and bytes
    saved; ``WeightOnlyLinear`` at the down_proj and lm_head shapes
    against its plain version (the same codes and scales in f32) per
    element; the RMS distance of a 1500-token prefill's logits from the
    bf16 model's; the serve phase's traffic through the engine (launches
    counted) and its greedy top-1 agreement with the bf16 streams.
    Random weights make agreement and distance hard to judge: both are
    reported, not gated."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn.quant import quantize_for_serving
    L = cfg.num_hidden_layers
    tokens = np.random.RandomState(9).randint(0, cfg.vocab_size, n_tokens)
    warm, prompts = _serve_traffic(cfg.vocab_size)
    n_new = 32
    gen = torch.Generator(device=dev).manual_seed(77)
    base = rms = None
    res = {"launches": {}}
    for algo in WOL_ALGOS:
        tag = f"weight_quant {algo[12:]}"
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=0)
        model.eval()
        if base is None:
            base = _prefill_logits(model, tokens).float()
            rms = base.square().mean().sqrt().item()
        dense = sum(p.numel() * p.element_size()
                    for p in model.parameters())
        t0 = time.perf_counter()
        stats = quantize_for_serving(model, algo)
        torch.cuda.synchronize()
        if stats["layers"] != 7 * L + 1 or not stats["bytes_saved"] > 0:
            raise AssertionError(f"[{tag}] converted {stats}")
        log(f"[{tag}] {stats['layers']} layers converted in "
            f"{time.perf_counter() - t0:.1f} s: {stats['bytes'] / 1e9:.3f} "
            f"GB of codes and scales, {stats['bytes_saved'] / 1e9:.3f} GB "
            f"saved of {dense / 1e9:.3f} GB of bf16 weights")
        for name, lin in (("down_proj", model.llama.layers[0].mlp.down_proj),
                          ("lm_head", model.lm_head)):
            codes = lin.codes().float()
            w16 = (codes * lin.weight_scale[:, None]).bfloat16()
            for rows in (8, 256):
                x = torch.randn(rows, lin.in_features, device=dev,
                                generator=gen).bfloat16()
                out = lin(x)
                xf = x.float()
                ref = (xf @ codes.t()) * lin.weight_scale
                mag = (xf.abs() @ codes.abs().t()) * lin.weight_scale
                # the product and the scaled result are each rounded to
                # bf16 once (1 ulp of |ref| together, 2 allowed); the
                # f32 sums of either side differ by far less than 2^-20
                # of the summed magnitudes
                err, worst = check_close(
                    f"{tag} {name} rows {rows}", out, ref,
                    2 * BF16_ULP * ref.abs() + 2 ** -20 * mag + 1e-6)
                ms = time_ms(lin, (x,))
                lib = time_ms(torch.nn.functional.linear, (x, w16))
                log(f"[{tag}] WeightOnlyLinear {name} x[{rows},"
                    f"{lin.in_features}] -> {lin.out_features}: max abs err "
                    f"{err:.3g} (limit 2 ulps of each |ref| + 2^-20 of the "
                    f"summed magnitudes, worst err/limit {worst:.3g}) "
                    f"{ms:.4f} ms, a bf16 linear over the dequantized "
                    f"weights {lib:.4f} ms")
            del codes, w16, x, out, ref, mag
        lq = _prefill_logits(model, tokens).float()
        if not torch.isfinite(lq).all():
            raise AssertionError(f"[{tag}] non-finite prefill logits")
        rel = ((lq - base).square().mean().sqrt() / rms).item()
        top1 = (lq.argmax(-1) == base.argmax(-1)).float().mean().item()
        log(f"[{tag}] {n_tokens}-token prefill: RMS logit difference / RMS "
            f"{rel:.4g} against the bf16 weights', top-1 agreement "
            f"{top1:.4f} (reported, not gated)")
        del lq
        eng = ContinuousBatchingEngine(model, num_slots=8, page_size=16,
                                       max_len=2048, prefill_chunk=256,
                                       decode_chunk=8, prefix_cache=False,
                                       audit=True, device=dev)
        if eng.pools[0].dtype != torch.bfloat16:
            raise AssertionError(f"[{tag}] pools {eng.pools[0].dtype}")
        eng.add_request(warm, 4)
        eng.run()
        eng.reset_gauges()
        torch.cuda.reset_peak_memory_stats()
        wrappers = _counted(SERVE_KERNELS)
        ids = [eng.add_request(p, n_new) for p in prompts]
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        _launch_check(tag, launches, eng._stats["forwards"], L)
        for n, c in launches.items():
            res["launches"][n] = res["launches"].get(n, 0) + c
        by = {r.request_id: r.tokens for r in done}
        streams = [by[i] for i in ids]
        if any(len(t) != n_new for t in streams):
            raise AssertionError(f"[{tag}] a request did not complete")
        _drain_check(tag, eng)
        agree = _agreement(streams, serve_streams)
        log(f"[{tag}] 12 requests x {n_new} new in {wall:.2f} s "
            f"({12 * n_new / wall:.1f} tok/s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; greedy top-1 "
            f"agreement with the bf16 weights' serve streams {agree:.4f} "
            f"({sum(a == b for a, b in zip(streams, serve_streams))}/12 "
            f"identical; reported, not gated); launches {launches}")
        res[algo] = dict(stats=stats, rel_rms=rel, top1=top1,
                         agreement=agree, tok_s=12 * n_new / wall)
        del eng, model
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    return res


# the kernels a training step may launch (each phase checks every count)
TRAIN_KERNELS = ("rms_norm", "rms_norm_dx", "rms_norm_residual",
                 "rms_norm_residual_dh", "swiglu", "swiglu_bwd",
                 "flash_attention_fwd", "flash_attention_dkv",
                 "flash_attention_dq", "chunk_stats", "chunk_dlogits")


def _wrappers(names):
    from paddle_tpu_torch.ops.kernels import ce_chunk as kce
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgmm
    from paddle_tpu_torch.ops.kernels import paged_attention as kpa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.ops.kernels import rms_norm as krms
    from paddle_tpu_torch.ops.kernels import swiglu as ksw
    every = {"rms_norm": krms.rms_norm, "rms_norm_dx": krms.rms_norm_dx,
             "rms_norm_residual": krms.rms_norm_residual,
             "rms_norm_residual_dh": krms.rms_norm_residual_dh,
             "chunk_stats": kce.chunk_stats,
             "chunk_dlogits": kce.chunk_dlogits,
             "swiglu": ksw.swiglu, "swiglu_bwd": ksw.swiglu_bwd,
             "flash_attention_fwd": kfa.flash_attention_fwd,
             "flash_attention_dkv": kfa.flash_attention_dkv,
             "flash_attention_dq": kfa.flash_attention_dq,
             "ragged_paged_attention": krpa.ragged_paged_attention,
             "ragged_paged_attention_quant":
                 krpa.ragged_paged_attention_quant,
             "paged_attention": kpa.paged_attention,
             "grouped_matmul": kgmm.grouped_matmul,
             "grouped_matmul_t": kgmm.grouped_matmul_t,
             "grouped_dw": kgmm.grouped_dw}
    return {n: every[n] for n in names}


def phase_train(cfg, layers=8, batch=2, seq=2048, warmup=2, steps=5,
                dev="cuda"):
    """Training at Llama-3-8B width: ``layers`` layers in bf16 with seeded
    random weights, the port's AdamW (f32 master weights and moments),
    ``model(ids, labels=ids); loss.backward(); opt.step();
    opt.clear_grad()`` on [batch, seq + 1] token ids, as bench.py's
    training step shapes them."""
    import dataclasses

    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    from paddle_tpu_torch.framework import flags
    if flags.flag("FLAGS_fused_rmsnorm_residual"):
        raise AssertionError("the train phase measures the unfused stack: "
                             "turn FLAGS_fused_rmsnorm_residual off first")
    log("[train] the unfused stack (FLAGS_fused_rmsnorm_residual off), as "
        "this phase has measured it since it was added")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] Llama-3-8B width, {layers} layers, {n_params / 1e9:.3f} B "
        f"params bf16, built in {time.perf_counter() - t0:.1f} s")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    # distinct inputs per step (bench.py rolls the batch the same way)
    step_ids = [torch.from_numpy(np.roll(ids, i, axis=1)).to(dev)
                for i in range(warmup + steps)]

    def step(t):
        _, loss = model(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.item()

    losses = [step(step_ids[i]) for i in range(warmup)]
    torch.cuda.synchronize()
    wrappers = _counted(TRAIN_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup, warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(step_ids[i]))   # .item() synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    # the seeded init predicts the first loss (_init_loss: 12.58 here;
    # the JAX bench's logged 10.875 at 2.37B, vocab 32000, hidden 2560,
    # is the same formula)
    ln_v = float(np.log(cfg.vocab_size))
    expect = _init_loss(cfg)
    if abs(losses[0] - expect) > 0.5:
        raise AssertionError(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                             f"of ln(vocab) + s2/2 = {expect:.4f}")
    L = layers
    want = {"rms_norm": 2 * L + 1, "rms_norm_dx": 2 * L + 1, "swiglu": L,
            "swiglu_bwd": L, "flash_attention_fwd": L,
            "flash_attention_dkv": L, "flash_attention_dq": L,
            "rms_norm_residual": 0, "rms_norm_residual_dh": 0,
            "chunk_stats": 0, "chunk_dlogits": 0}
    per_step = {k: v / steps for k, v in launches.items()}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step} != {want}")
    t = Timing(times)
    tokens = batch * seq
    flops = 6.0 * n_params * tokens + 12.0 * L * batch * seq * seq \
        * cfg.hidden_size
    log(f"[train] {steps} steps of [{batch}, {seq + 1}] tokens: step "
        f"{t:.1f} ms (median [least-greatest]), {tokens / (t / 1e3):.0f} "
        f"tokens/s, model FLOPs {flops / 1e12:.1f} TFLOP a step = "
        f"{100 * flops / (t / 1e3) / PEAK_BF16:.1f}% of {PEAK_BF16 / 1e12:.0f} "
        f"TFLOP/s, peak memory {peak:.2f} GB")
    log(f"[train] losses {[round(x, 4) for x in losses]} (ln vocab "
        f"{ln_v:.4f}, + s2/2 from the init: {expect:.4f})")
    log(f"[train] launches per step {per_step}")
    breakdown = _step_breakdown(model, opt, step_ids[-1])
    # five more steps on one fixed batch must lower its loss
    fixed = step_ids[0]
    with torch.no_grad():
        before = model(fixed, labels=fixed)[1].item()
    for _ in range(5):
        step(fixed)
    with torch.no_grad():
        after = model(fixed, labels=fixed)[1].item()
    if not after < before:
        raise AssertionError(f"5 steps on one batch did not lower its loss: "
                             f"{before:.4f} -> {after:.4f}")
    log(f"[train] one fixed batch: loss {before:.4f} -> {after:.4f} after 5 "
        f"steps on it")
    del model, opt, step_ids
    torch.cuda.empty_cache()
    return dict(step_ms=t, tokens_per_s=tokens / (t / 1e3),
                mfu=flops / (t / 1e3) / PEAK_BF16, peak_gb=peak,
                losses=losses, launches=launches, breakdown=breakdown)


# kernel-name fragments -> the layer they belong to (cuBLAS's H100
# matmuls are the nvjet/sm90 gemm kernels)
_CATEGORIES = (("grouped matmul K14/K15", ("gmm_", "gdw_")),
               ("attention K7-K9", ("flash_fwd", "flash_dkv", "flash_dq")),
               ("paged attention K12/K13/K16", ("ragged_", "paged_decode",
                                                "paged_split")),
               ("rms_norm K1-K4", ("rms_norm",)),
               ("swiglu K5/K6", ("swiglu",)),
               ("ce_chunk K10/K11", ("ce_stats", "ce_dlogits")),
               ("matmul (cuBLAS)", ("gemm", "nvjet", "sm90_xmma", "cutlass")),
               ("routing and gathers", ("index", "scatter", "gather", "sort",
                                        "topk", "searchsorted", "cumsum",
                                        "unique", "Radix", "radix")))


def _step_breakdown(model, opt, ids):
    """One more training step, timed in three parts with CUDA events on
    the stream (forward, backward, optimizer: device time including any
    idle gap the host leaves), then once more under torch.profiler."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    _, loss = model(ids, labels=ids)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    opt.clear_grad()
    ev[3].record()
    torch.cuda.synchronize()
    parts = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
             enumerate(("forward", "backward", "optimizer"))}
    log("[train] one step by part (CUDA events): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in parts.items()))

    def step():
        _, loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
    return dict(parts=parts, **_profile("train", step))


def _profile(tag, fn, per=1, cpu=True):
    """``fn()`` once under torch.profiler: device time by kernel and by
    layer, and the device's idle share of the wall time (``per``: the
    steps ``fn`` runs, to report per step; ``cpu``: trace the host's
    operators too)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + [ProfilerActivity.CPU] * cpu) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / per
    # the device events straight from the trace: the same totals by name
    # as key_averages(), which builds a Python object for every host
    # event of the trace and so takes many times the profiled run itself
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels[e.name()] = (kernels.get(e.name(), 0.0)
                                 + e.duration_ns() / 1e6 / per)
    busy = sum(kernels.values())
    if not busy:
        log(f"[{tag}] the profiler saw no device time (not measured)")
        return {}
    by_cat = {}
    for name, ms in kernels.items():
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    log(f"[{tag}] profiled step: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
    log(f"[{tag}] device time by layer: " + ", ".join(
        f"{c} {ms:.1f} ms ({100 * ms / busy:.1f}%)" for c, ms in
        sorted(by_cat.items(), key=lambda x: -x[1])))
    for name, ms in sorted(kernels.items(), key=lambda x: -x[1])[:12]:
        log(f"[{tag}]   {ms:8.2f} ms  {name[:110]}")
    # the device symbols of the hand-written attention and grouped-matmul
    # kernels this step ran: which kernel each path took
    symbols = {}
    for cat in ("attention K7-K9", "paged attention K12/K13/K16",
                "grouped matmul K14/K15"):
        keys = dict(_CATEGORIES)[cat]
        ran = {_symbol(n): ms for n, ms in kernels.items()
               if any(k in n for k in keys)}
        if ran:
            symbols[cat] = ran
            log(f"[{tag}] {cat} kernels: " + ", ".join(
                f"{n} {ms:.2f} ms" for n, ms in sorted(
                    ran.items(), key=lambda x: -x[1])))
    return dict(wall_ms=wall, busy_ms=busy, by_layer=by_cat,
                symbols=symbols)


def _symbol(name):
    """A kernel's device symbol without its return type, namespace and
    arguments: 'flash_fwd_wgmma<128>'."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def _twin(template, name):
    """A copy of the model ``template`` on device ``name``, weights and
    buffers bit for bit. The parity phases build their seeded template
    on the card and copy it to the CPU: a seeded initialisation of every
    weight on the host takes seconds at Llama-1B's width."""
    import copy
    return copy.deepcopy(template).to(name)


def phase_train_parity(cfg1b, layers=2, seq=300, lr=1e-3, dev="cuda"):
    """One forward + backward + AdamW step at Llama-1B width (depth
    ``layers``, f32, batch 1, ``seq`` tokens, not a tile multiple) from
    the same weights on the card (kernels) and on the CPU (plain
    versions): the loss, every gradient and every updated weight."""
    import dataclasses

    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, seq)))
    template = LlamaForCausalLM(cfg, device=dev, seed=7)
    out = {}
    for name in ("cpu", dev):
        t0 = time.perf_counter()
        model = _twin(template, name)
        opt = AdamW(learning_rate=lr, parameters=model.parameters())
        t = ids.to(name)
        _, loss = model(t, labels=t)
        loss.backward()
        grads = convert.grads_to_numpy(model)
        opt.step()
        out[name] = (loss.item(), grads, convert.to_numpy_state_dict(model))
        log(f"[train_parity] {name}: loss {out[name][0]:.6f} in "
            f"{time.perf_counter() - t0:.1f} s")
        del model, opt
    (l0, g0, w0), (l1, g1, w1) = out["cpu"], out[dev]
    # f32 on both sides: the kernels, cuBLAS and the CPU sum in other
    # orders, some 1e-7 relative a sum; through two layers and a 32000-way
    # log-softmax the loss keeps 1e-5 of itself
    if abs(l1 - l0) > 1e-5 * abs(l0):
        raise AssertionError(f"loss {l1} on the card vs {l0} on the CPU")
    worst_g = 0.0
    for key in g0:
        # whole-tensor relative error: f32 noise is some 1e-6 here; one
        # key dropped in attention or a kernel's wrong tile moves a
        # gradient by 1e-3 or more
        err = float(np.linalg.norm(g1[key] - g0[key])
                    / max(np.linalg.norm(g0[key]), 1e-30))
        worst_g = max(worst_g, err)
        if err > 1e-4:
            raise AssertionError(f"grad {key}: relative error {err:.3g}")
    worst_w = 0.0
    for key in w0:
        # per element: the first step's sensitivity to the two grads'
        # difference (adam_first_step_limit)
        lim = adam_first_step_limit(g0[key], g1[key], w0[key], lr)
        ratio = float((np.abs(w1[key] - w0[key]) / lim).max())
        worst_w = max(worst_w, ratio)
        if ratio > 1:
            raise AssertionError(f"weight {key} after the step: worst "
                                 f"err/limit {ratio:.3g}")
    log(f"[train_parity] Llama-1B width, {layers} layers, f32, [1, {seq}]: "
        f"loss card {l1:.6f} vs CPU {l0:.6f}; {len(g0)} grads, worst "
        f"relative error {worst_g:.3g} (limit 1e-4); {len(w0)} updated "
        f"weights, worst err/limit {worst_w:.3g}")
    return worst_g, worst_w


def _init_loss(cfg):
    """The step-0 loss the seeded init predicts: the final hidden states
    are RMS-normalised (mean square 1) and the lm_head weights are
    N(0, initializer_range), so each logit is about N(0, s2) with s2 =
    hidden * range^2, and the cross entropy is about ln(vocab) + s2 / 2."""
    return (float(np.log(cfg.vocab_size))
            + cfg.hidden_size * cfg.initializer_range ** 2 / 2)


def _counted(names):
    wrappers = _wrappers(names)
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def phase_train_full(cfg, batch=4, seq=2048, warmup=2, steps=5, dev="cuda"):
    """bench.py's headline training step (_train_bench) on the port: the
    full-depth Llama-3-8B in bf16 with seeded random weights, token ids
    [batch, seq + 1] from RandomState(0) rolled per step, core_attn
    recompute under dots_saveable, the fused residual carry, the loss over
    full logits; forward and backward with the grads cleared and no
    optimizer."""
    import dataclasses

    import torch
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.models import LlamaForCausalLM
    want_flags = {"FLAGS_fused_rmsnorm_residual": True,
                  "FLAGS_fused_linear_cross_entropy": False,
                  "FLAGS_recompute_policy": "dots_saveable"}
    got = flags.get_flags(list(want_flags))
    if got != want_flags:
        raise AssertionError(f"train_full needs {want_flags}, not {got}")
    cfg = dataclasses.replace(cfg, use_recompute=True,
                              recompute_granularity="core_attn")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L = cfg.num_hidden_layers
    log(f"[train_full] Llama-3-8B, {L} layers, {n_params / 1e9:.3f} B params "
        f"bf16, core_attn recompute (dots_saveable), fused residual carry, "
        f"built in {time.perf_counter() - t0:.1f} s")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    step_ids = [torch.from_numpy(np.roll(ids, i, axis=1)).to(dev)
                for i in range(warmup + steps)]

    def step(t):
        _, loss = model(t, labels=t)
        loss.backward()
        for p in model.parameters():
            p.grad = None
        return loss.item()

    losses = [step(step_ids[i]) for i in range(warmup)]
    wrappers = _counted(TRAIN_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup, warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(step_ids[i]))   # .item() synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    expect = _init_loss(cfg)
    if abs(losses[0] - expect) > 0.5:
        raise AssertionError(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                             f"of ln(vocab) + s2/2 = {expect:.4f}")
    # one step: layer 0's input norm is plain (K1), then every add+norm
    # pair is K3: 2 a layer less the first, and the final norm (2L);
    # core_attn recomputes both regions of every layer in the backward,
    # re-running K1 once, K3 2L - 1 times and K5 L times; flash attention
    # stays outside the regions
    want = {"rms_norm": 2, "rms_norm_dx": 1, "rms_norm_residual": 4 * L - 1,
            "rms_norm_residual_dh": 2 * L, "swiglu": 2 * L, "swiglu_bwd": L,
            "flash_attention_fwd": L, "flash_attention_dkv": L,
            "flash_attention_dq": L, "chunk_stats": 0, "chunk_dlogits": 0}
    per_step = {k: v / steps for k, v in launches.items()}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step} != {want}")
    t = Timing(times)
    tokens = batch * seq
    # bench.py's count: model FLOPs only, recompute not counted
    flops = 6.0 * n_params * tokens + 12.0 * L * batch * seq * seq \
        * cfg.hidden_size
    log(f"[train_full] {steps} steps of [{batch}, {seq + 1}] tokens: step "
        f"{t:.1f} ms (median [least-greatest]), {tokens / (t / 1e3):.0f} "
        f"tokens/s, model FLOPs {flops / 1e12:.1f} TFLOP a step = "
        f"{100 * flops / (t / 1e3) / PEAK_BF16:.1f}% of "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s, peak memory {peak:.2f} GB")
    log(f"[train_full] losses {[round(x, 4) for x in losses]} (predicted "
        f"from the init: {expect:.4f})")
    log(f"[train_full] launches per step {per_step}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t_ = step_ids[-1]
    ev[0].record()
    _, loss = model(t_, labels=t_)
    ev[1].record()
    loss.backward()
    ev[2].record()
    torch.cuda.synchronize()
    parts = {"forward": ev[0].elapsed_time(ev[1]),
             "backward with recompute": ev[1].elapsed_time(ev[2])}
    log("[train_full] one step by part (CUDA events): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in parts.items()))
    del loss
    for p in model.parameters():
        p.grad = None
    prof = _profile("train_full", lambda: step(t_))
    del model, step_ids
    torch.cuda.empty_cache()
    return dict(step_ms=t, tokens_per_s=tokens / (t / 1e3),
                mfu=flops / (t / 1e3) / PEAK_BF16, peak_gb=peak,
                losses=losses, launches=launches, parts=parts, profile=prof)


def phase_2_4b_kernels(batch=2, seq=2049, dev="cuda"):
    """K1-K9 at the shapes of phase train_2_4b (llama_2_4b: [2, 2049]
    tokens of width 2560, FFN 6912, 20 query heads over 4 KV heads of 128,
    the first path with 5 query heads to a KV head) against their plain
    versions per element, bits repeated, timed beside their bounds (K3/K4
    through phase_fused_kernels, whose K10/K11 checks run again at a
    small block). Returns {kernel: {"llama_2_4b": entry}}."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig.llama_2_4b()
    gen = torch.Generator(device=dev).manual_seed(2404)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)
    n = batch * seq
    entries = {}
    entries.update(norm_checks(n, cfg.hidden_size, cfg.rms_norm_eps, rand,
                               tag="train_2_4b kernels"))
    entries.update(swiglu_checks(n, cfg.intermediate_size, rand,
                                 tag="train_2_4b kernels"))
    torch.cuda.empty_cache()
    entries.update(flash_checks(batch, seq, cfg.num_attention_heads,
                                cfg.num_key_value_heads, cfg.head_dim, rand))
    fused = phase_fused_kernels(cfg, n_res=n, n_ce=1024, vc=1024)
    for name in ("rms_norm_residual", "rms_norm_residual_dh"):
        entries[name] = fused[name]
    torch.cuda.empty_cache()
    return {name: {"llama_2_4b": e} for name, e in entries.items()}


POLICIES = ("dots_saveable", "nothing_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable",
            "dots_and_flash_saveable")
# the parameters whose gradients the policies must agree on
GRAD_SAMPLE = ("llama.embed_tokens.weight",
               "llama.layers.0.self_attn.q_proj.weight",
               "llama.layers.15.mlp.down_proj.weight",
               "llama.layers.31.post_attention_layernorm.weight",
               "llama.norm.weight", "lm_head.weight")
K_OF = {"rms_norm": "K1", "rms_norm_dx": "K2", "rms_norm_residual": "K3",
        "rms_norm_residual_dh": "K4", "swiglu": "K5", "swiglu_bwd": "K6",
        "flash_attention_fwd": "K7", "flash_attention_dkv": "K8",
        "flash_attention_dq": "K9"}


def _k_label(symbol):
    """K1-K9 for a device symbol of csrc/rms_norm.cu, swiglu.cu or
    flash_attention.cu (the rms_norm kernels' last template argument is
    the residual variant), else None."""
    base, _, args = symbol.partition("<")
    res = args.rstrip(">").split(",")[-1].strip() == "true"
    return {"rms_norm_kernel": "K3" if res else "K1",
            "rms_norm_dx_kernel": "K4" if res else "K2",
            "swiglu_kernel": "K5", "swiglu_bwd_kernel": "K6"}.get(base) or \
        next((k for pre, k in (("flash_fwd", "K7"), ("flash_dkv", "K8"),
                               ("flash_dq", "K9")) if base.startswith(pre)),
             None)


def phase_train_2_4b(batch=2, seq=2048, dev="cuda"):
    """The JAX bench's other headline training configuration
    (bench.py:_train_bench's llama_2_4b branch) at full width and depth:
    bf16, [2, 2049] token ids from RandomState(0) rolled per step, built
    after paddle_tpu_torch.seed(0), forward and backward with the grads
    cleared. (a) the preset as written (core_attn on every second layer,
    the unrolled fused stack): 2 warm-up and 5 timed steps, MFU from
    profiler.cost, peak memory, exact launches a step; (b) each recompute
    policy at ``full`` granularity: losses equal bit for bit, sampled
    gradients within a stated bound; (c) scan_layers=True with core_attn:
    the warning, and the loss of the unrolled full run; then 3 timed steps
    at full, beside (b)'s unrolled dots_saveable; (d) one run under
    Profiler(targets=[GPU], scheduler=(1, 3), with_flops=True): its chrome
    export names K1-K9; (e) amp.debugging: check_numerics over the
    gradients, collect_operator_stats over a step, enable_check_nan_inf
    quiet over a clean forward and raising, naming the op, on an inf
    added to one layer's MLP output."""
    import contextlib
    import io as _io
    import shutil
    import tempfile
    import warnings

    import torch
    import paddle_tpu_torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget, cost,
                                           export_chrome_tracing,
                                           get_tracer, trace_span)
    want_flags = {"FLAGS_fused_rmsnorm_residual": True,
                  "FLAGS_fused_linear_cross_entropy": False,
                  "FLAGS_recompute_policy": "dots_saveable"}
    got = flags.get_flags(list(want_flags))
    if got != want_flags:
        raise AssertionError(f"train_2_4b needs {want_flags}, not {got}")
    cfg = LlamaConfig.llama_2_4b()
    paddle_tpu_torch.seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L, interval = cfg.num_hidden_layers, cfg.core_attn_interval
    peaks = cost.device_peaks()
    log(f"[train_2_4b] llama_2_4b: {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, FFN "
        f"{cfg.intermediate_size}, {n_params / 1e9:.3f} B params bf16, "
        f"core_attn every {interval}nd layer, unrolled fused stack; built "
        f"in {time.perf_counter() - t0:.1f} s")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    step_ids = [torch.from_numpy(np.roll(ids, i, axis=1)).to(dev)
                for i in range(7)]
    params = dict(model.named_parameters())

    def step(t, keep=()):
        _, loss = model(t, labels=t)
        loss.backward()
        kept = {n: params[n].grad.clone() for n in keep}
        for p in model.parameters():
            p.grad = None
        return loss.item(), kept

    tokens = batch * seq
    flops = cost.transformer_step_flops(n_params, tokens, L, batch, seq,
                                        cfg.hidden_size)

    # (a) the preset as written
    losses = [step(step_ids[i])[0] for i in range(2)]
    wrappers = _counted(TRAIN_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2, 7):
        t0 = time.perf_counter()
        losses.append(step(step_ids[i])[0])
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    expect = _init_loss(cfg)
    if abs(losses[0] - expect) > 0.5:
        raise AssertionError(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                             f"of ln(vocab) + s2/2 = {expect:.4f}")
    # as train_full's count, with core_attn on the even layers only: the
    # odd layers recompute whole (forward_fused), flash attention
    # included, so K7 runs again for each of them
    n_whole = sum(1 for i in range(L) if i % interval)
    want = {"rms_norm": 2, "rms_norm_dx": 1, "rms_norm_residual": 4 * L - 1,
            "rms_norm_residual_dh": 2 * L, "swiglu": 2 * L, "swiglu_bwd": L,
            "flash_attention_fwd": L + n_whole, "flash_attention_dkv": L,
            "flash_attention_dq": L, "chunk_stats": 0, "chunk_dlogits": 0}
    per_step = {k: v / 5 for k, v in launches.items()}
    log(f"[train_2_4b] launches per step " + ", ".join(
        f"{K_OF.get(k, k)} {v:g}" for k, v in per_step.items()))
    if per_step != want:
        raise AssertionError(f"launches per step {per_step} != {want}")
    t = Timing(times)
    mfu = cost.mfu(flops, t / 1e3, peak=peaks.flops)
    log(f"[train_2_4b] (a) 5 steps of [{batch}, {seq + 1}] tokens: step "
        f"{t:.1f} ms (median [least-greatest]), {tokens / (t / 1e3):.0f} "
        f"tokens/s, model FLOPs {flops / 1e12:.2f} TFLOP a step "
        f"(profiler.cost.transformer_step_flops) = MFU {100 * mfu:.1f}% of "
        f"{peaks.flops / 1e12:.1f} TFLOP/s ({peaks.kind}), peak memory "
        f"{peak:.2f} GB; losses {[round(x, 4) for x in losses]} (init "
        f"predicts {expect:.4f})")

    # (b) the five policies at full granularity
    model.config.recompute_granularity = "full"
    pol = {}
    try:
        for name in POLICIES:
            flags.set_flags({"FLAGS_recompute_policy": name})
            ls = [step(step_ids[0])[0]]
            torch.cuda.reset_peak_memory_stats()
            tt = []
            for i in (1, 2, 3):
                t0 = time.perf_counter()
                loss, kept = step(step_ids[i],
                                  GRAD_SAMPLE if i == 3 else ())
                tt.append((time.perf_counter() - t0) * 1e3)
                ls.append(loss)
            pol[name] = dict(losses=ls, grads=kept, step_ms=Timing(tt),
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            log(f"[train_2_4b] (b) {name}: step {pol[name]['step_ms']:.1f} "
                f"ms, peak memory {pol[name]['peak_gb']:.2f} GB, losses "
                f"{[round(x, 5) for x in ls]}")
    finally:
        flags.set_flags({"FLAGS_recompute_policy": "dots_saveable"})
    ref = pol["dots_saveable"]
    for name, r in pol.items():
        if r["losses"] != ref["losses"]:
            raise AssertionError(f"{name}: losses {r['losses']} are not "
                                 f"dots_saveable's {ref['losses']}")
        # a recompute replays the same kernels on the same inputs, whose
        # bits repeat: the gradients should be equal; the bound is one
        # bf16 ulp of each parameter's largest |g|
        for pname, g in r["grads"].items():
            g0 = ref["grads"][pname]
            err = (g.float() - g0.float()).abs().max().item()
            lim = BF16_ULP * g0.float().abs().max().item()
            if err > lim:
                raise AssertionError(
                    f"{name}: grad of {pname} differs from dots_saveable's "
                    f"by {err:.3g} > {lim:.3g}")
        same = all(torch.equal(g, ref["grads"][n])
                   for n, g in r["grads"].items())
        grads = "bit-equal" if same else "within one bf16 ulp of max|g|"
        log(f"[train_2_4b] (b) {name}: losses equal to dots_saveable's bit "
            f"for bit; sampled gradients {grads}")

    # (c) scan_layers=True with core_attn: the warning and the full loss
    model.config.scan_layers = True
    model.config.recompute_granularity = "core_attn"
    try:
        wrappers = _counted(TRAIN_KERNELS)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            scan_loss = step(step_ids[0])[0]
        scan_launches = {K_OF.get(k, k): w.launches
                         for k, w in wrappers.items()}
        # the default stack's cost: full recompute under dots_saveable,
        # as (b)'s unrolled dots_saveable run
        model.config.recompute_granularity = "full"
        torch.cuda.reset_peak_memory_stats()
        tt = []
        for i in (1, 2, 3):
            t0 = time.perf_counter()
            step(step_ids[i])
            tt.append((time.perf_counter() - t0) * 1e3)
        scan_ms = Timing(tt)
        scan_peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        model.config.scan_layers = False
    if not any("recompute_granularity is ignored" in str(w.message)
               for w in caught):
        raise AssertionError("train_2_4b: scan_layers=True with core_attn "
                             "gave no granularity warning")
    if scan_loss != ref["losses"][0]:
        raise AssertionError(f"scanned loss {scan_loss} != the unrolled "
                             f"full run's {ref['losses'][0]}")
    if scan_launches["K3"] or not scan_launches["K1"]:
        raise AssertionError(f"the scanned stack's launches {scan_launches}"
                             f" are not the single-tensor carry's")
    log(f"[train_2_4b] (c) scan_layers=True, core_attn: the granularity "
        f"warning fired; loss {scan_loss!r} equals the unrolled full run's "
        f"bit for bit; launches of the step {scan_launches}")
    log(f"[train_2_4b] (c) scanned, full: step {scan_ms:.1f} ms, peak memory "
        f"{scan_peak:.2f} GB; the unrolled stack's (b) dots_saveable "
        f"{ref['step_ms']:.1f} ms, {ref['peak_gb']:.2f} GB")

    # (d) Profiler with the GPU target over steps 1 and 2
    log_dir = tempfile.mkdtemp(prefix="train_2_4b_prof_")
    try:
        get_tracer().clear()
        with Profiler(targets=[ProfilerTarget.GPU], scheduler=(1, 3),
                      with_flops=True,
                      on_trace_ready=export_chrome_tracing(log_dir)) as prof:
            for i in range(4):
                with trace_span("train_2_4b/step", flops=flops):
                    step(step_ids[i])
                prof.step()
        if len(prof.trace_paths) != 1:
            raise AssertionError(f"Profiler wrote {prof.trace_paths}")
        with open(prof.trace_paths[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                k = _k_label(_symbol(e["name"]))
                if k:
                    kernels.setdefault(k, set()).add(_symbol(e["name"]))
        size_mb = os.path.getsize(prof.trace_paths[0]) / 2 ** 20
        sec = get_tracer().section_summary(
            peak_flops=peaks.flops)["train_2_4b/step"]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    missing = sorted(set(K_OF.values()) - set(kernels))
    if missing:
        raise AssertionError(f"the Profiler's trace lacks {missing}")
    log(f"[train_2_4b] (d) Profiler chrome trace ({size_mb:.1f} MiB, steps "
        f"1-2) names " + ", ".join(f"{k} {sorted(v)}" for k, v in
                                   sorted(kernels.items())))
    log(f"[train_2_4b] (d) trace.section_summary: {sec['count']} steps, mean "
        f"{sec['mean_ms']:.1f} ms, MFU {100 * sec['mfu']:.1f}% (host spans, "
        f"the profiled steps included)")

    # (e) amp.debugging
    _, kept = step(step_ids[0], tuple(params))
    for name, g in kept.items():
        amp.debugging.check_numerics(g, "grad", name)
    del kept
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        with amp.debugging.collect_operator_stats():
            step(step_ids[1])
    stats = [ln.strip() for ln in buf.getvalue().splitlines()[1:]]
    top = sorted(stats, key=lambda x: -int(x.rsplit(": ", 1)[1]))[:6]
    log(f"[train_2_4b] (e) check_numerics over {len(params)} gradients: "
        f"finite; collect_operator_stats over one step: {len(stats)} "
        f"(op, dtype) entries, most called {top}")
    model.eval()
    try:
        amp.debugging.enable_check_nan_inf()
        try:
            with torch.no_grad():
                model(step_ids[0])
        finally:
            amp.debugging.disable_check_nan_inf()
        bump = torch.full((), float("inf"), dtype=torch.bfloat16,
                          device=dev)
        hook = model.llama.layers[3].mlp.register_forward_hook(
            lambda mod, args, out: out + bump)
        raised = None
        amp.debugging.enable_check_nan_inf()
        try:
            with torch.no_grad():
                model(step_ids[0])
        except FloatingPointError as e:
            raised = str(e)
        finally:
            amp.debugging.disable_check_nan_inf()
            hook.remove()
    finally:
        model.train()
    if raised is None or "aten.add" not in raised:
        raise AssertionError(f"check_nan_inf did not name the op: {raised}")
    log(f"[train_2_4b] (e) enable_check_nan_inf: a clean forward passes; an "
        f"inf added to layer 3's MLP output raises {raised!r}")
    del model, step_ids, params
    torch.cuda.empty_cache()
    return dict(step_ms=t, mfu=mfu, peak_gb=peak, losses=losses,
                launches=launches,
                policies={n: dict(step_ms=r["step_ms"], peak_gb=r["peak_gb"])
                          for n, r in pol.items()},
                scan_loss=scan_loss, trace_kernels=sorted(kernels))


def phase_fit(cfg1b, batch=8, seq=1024, n_batches=12, dev="cuda"):
    """bench.py's _fit_e2e_bench on the port: Llama-1B at full depth in
    bf16, ``Model(net).prepare(SGD(1e-4), LlamaPretrainingCriterion)``,
    ``fit`` over ``n_batches`` batches of [batch, seq + 1] for 2 epochs
    (epoch 0 warms up, epoch 1 is measured), the fused linear+CE on by
    fit's default."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import functional as pF
    from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
    from paddle_tpu_torch.optimizer import SGD
    cfg = cfg1b
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    m = Model(model)
    m.prepare(SGD(1e-4, parameters=model.parameters()),
              LlamaPretrainingCriterion(cfg))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch * n_batches, seq + 1))).to(dev)
    ds = TensorDataset([ids, ids])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L = cfg.num_hidden_layers
    log(f"[fit] Llama-1B, {L} layers, {n_params / 1e9:.3f} B params bf16, "
        f"SGD(1e-4), {n_batches} batches of [{batch}, {seq + 1}], built in "
        f"{time.perf_counter() - t0:.1f} s")
    wrappers = _counted(TRAIN_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    m.fit(ds, batch_size=batch, epochs=2, shuffle=False, verbose=0)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if flags.flag("FLAGS_fused_linear_cross_entropy") is not False:
        raise AssertionError("fit left FLAGS_fused_linear_cross_entropy on")
    e0, e1 = m._epoch_summaries
    expect = _init_loss(cfg)
    if not (np.isfinite(e0["mean_loss"]) and np.isfinite(e1["mean_loss"])
            and abs(e0["mean_loss"] - expect) < 0.5):
        raise AssertionError(f"epoch mean losses {e0['mean_loss']}, "
                             f"{e1['mean_loss']}; predicted from the init "
                             f"{expect:.4f}")
    # a step: the fused carry (K1 once, K3 2L, K4 2L, K2 once), one
    # SwiGLU and one attention a layer, and the vocab in chunks of 1024:
    # 32 for V = 32000, the last clamped with lo = 768 (K10 forward, K11
    # backward)
    chunks = -(-cfg.vocab_size // 1024)
    want = {"rms_norm": 1, "rms_norm_dx": 1, "rms_norm_residual": 2 * L,
            "rms_norm_residual_dh": 2 * L, "swiglu": L, "swiglu_bwd": L,
            "flash_attention_fwd": L, "flash_attention_dkv": L,
            "flash_attention_dq": L, "chunk_stats": chunks,
            "chunk_dlogits": chunks}
    n_steps = e0["steps"] + e1["steps"]
    per_step = {k: v / n_steps for k, v in launches.items()}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step} != {want}")
    avg = e1["avg_step_ms"]
    tokens = batch * seq
    log(f"[fit] epoch 1: {e1['steps']} steps in {e1['seconds']:.3f} s, "
        f"avg_step_ms {avg:.2f}, {tokens / (avg / 1e3):.0f} tokens/s, peak "
        f"memory {peak:.2f} GB; mean loss epoch 0 {e0['mean_loss']:.6f}, "
        f"epoch 1 {e1['mean_loss']:.6f} (predicted from the init "
        f"{expect:.4f}); epoch 0 (warm-up) avg_step_ms "
        f"{e0['avg_step_ms']:.2f}")
    log(f"[fit] launches per step {per_step}; "
        f"FLAGS_fused_linear_cross_entropy back to False")
    # the loss tail alone at the fit shape, fused (32 chunks: K10 and
    # K11 with their matmuls) against materialised logits and the CE
    gen = torch.Generator(device=dev).manual_seed(11)
    h = torch.randn(tokens, cfg.hidden_size, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_()
    w = model.lm_head.weight.detach().clone().requires_grad_()
    lab = ids[:batch, 1:].reshape(-1)

    def fused_tail(h, w, lab):
        loss = fused_linear_cross_entropy(h, w.t(), lab)
        return torch.autograd.grad(loss, (h, w))

    def plain_tail(h, w, lab):
        # the unfused model's tail: logits, then the port's f32 CE
        loss = pF.cross_entropy(tF.linear(h, w), lab)
        return torch.autograd.grad(loss, (h, w))
    tails = {"fused": eager_ms(fused_tail, (h, w, lab), iters=5),
             "logits": eager_ms(plain_tail, (h, w, lab), iters=5)}
    log(f"[fit] loss tail forward+backward, h [{tokens}, {cfg.hidden_size}] "
        f"x V {cfg.vocab_size} bf16 (eager, host included): fused "
        f"{tails['fused']:.3f} ms, over materialised logits "
        f"{tails['logits']:.3f} ms")
    del h, w
    few = TensorDataset([ids[:2 * batch], ids[:2 * batch]])
    prof = _profile("fit", lambda: m.fit(few, batch_size=batch, epochs=1,
                                         shuffle=False, verbose=0), per=2)
    del m, model, ids, ds, few
    torch.cuda.empty_cache()
    return dict(avg_step_ms=avg, tokens_per_s=tokens / (avg / 1e3),
                peak_gb=peak, mean_loss=(e0["mean_loss"], e1["mean_loss"]),
                launches=launches, tails=tails, profile=prof)


def phase_fused_parity(cfg1b, layers=2, seq=300, dev="cuda"):
    """Llama-1B width at depth ``layers`` in f32, the card (kernels)
    against the CPU (plain versions) from the same weights: (a) a
    labelled forward and backward with the fused residual carry and
    core_attn recompute on [1, seq] ids: the loss and every gradient;
    (b) ``fit(compiled=True)`` with SGD over 2 batches of [2, 129]: the
    mean loss and every updated weight."""
    import dataclasses

    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import SGD
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers,
                              use_recompute=True,
                              recompute_granularity="core_attn")
    template = LlamaForCausalLM(cfg, device=dev, seed=9)
    weights = template.state_dict()
    ids = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (1, seq)))
    out = {}
    for name in ("cpu", dev):
        model = _twin(template, name)
        t = ids.to(name)
        _, loss = model(t, labels=t)
        loss.backward()
        out[name] = (loss.item(), convert.grads_to_numpy(model))
        del model
    (l0, g0), (l1, g1) = out["cpu"], out[dev]
    # f32 on both sides: as train_parity, the loss within 1e-5 of itself
    # and every gradient within 1e-4 (whole-tensor relative)
    if abs(l1 - l0) > 1e-5 * abs(l0):
        raise AssertionError(f"fused_parity (a): loss {l1} on the card vs "
                             f"{l0} on the CPU")
    worst_g = max(float(np.linalg.norm(g1[k] - g0[k])
                        / max(np.linalg.norm(g0[k]), 1e-30)) for k in g0)
    if worst_g > 1e-4:
        raise AssertionError(f"fused_parity (a): a gradient's relative "
                             f"error is {worst_g:.3g}")
    log(f"[fused_parity] (a) Llama-1B width, {layers} layers, f32, fused "
        f"carry + core_attn recompute, [1, {seq}]: loss card {l1:.6f} vs CPU "
        f"{l0:.6f}; {len(g0)} grads, worst relative error {worst_g:.3g} "
        f"(limit 1e-4)")
    cfg = dataclasses.replace(cfg, use_recompute=False)
    w_init = convert.to_numpy_state_dict(template)
    del template
    rows = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (4, 129)))
    lr, out = 1e-2, {}
    for name in ("cpu", dev):
        model = LlamaForCausalLM(cfg, device=name)
        model.load_state_dict(weights)
        m = Model(model)
        m.prepare(SGD(lr, parameters=model.parameters()),
                  LlamaPretrainingCriterion(cfg))
        t = rows.to(name)
        m.fit(TensorDataset([t, t]), batch_size=2, epochs=1, shuffle=False,
              verbose=0)
        out[name] = (m._last_epoch_summary["mean_loss"],
                     convert.to_numpy_state_dict(model))
        del m, model
    (l0, w0), (l1, w1) = out["cpu"], out[dev]
    if abs(l1 - l0) > 1e-5 * abs(l0):
        raise AssertionError(f"fused_parity (b): mean loss {l1} on the card "
                             f"vs {l0} on the CPU")
    worst_w = 0.0
    for key in w0:
        # per element: the f32 rounding of the weight (a few ulps, 1e-6
        # of |w|) plus the gradients' f32 noise times lr, at most 1e-4 of
        # the tensor's largest update over the epoch
        moved = np.abs(w0[key] - w_init[key]).max()
        lim = 1e-6 * np.abs(w0[key]) + 1e-4 * moved + 1e-9
        ratio = float((np.abs(w1[key] - w0[key]) / lim).max())
        worst_w = max(worst_w, ratio)
        if ratio > 1:
            raise AssertionError(f"fused_parity (b): weight {key} after fit: "
                                 f"worst err/limit {ratio:.3g}")
    log(f"[fused_parity] (b) fit(compiled=True), SGD lr {lr}, 2 batches of "
        f"[2, 129]: mean loss card {l1:.6f} vs CPU {l0:.6f}; {len(w0)} "
        f"updated weights, worst err/limit {worst_w:.3g}")
    torch.cuda.empty_cache()
    return worst_g, worst_w


def synthetic_corpus(vocab, n_tokens, seed=0, chains=64):
    """examples/train_gpt2.py's Markov corpus, vectorised: the same
    transition matrix for the seed (rows of a Dirichlet(0.05) draw), the
    tokens walked by ``chains`` chains side by side (one uniform draw and
    one row lookup a step for all of them) and laid end to end. The
    stream has the same statistics, not the same tokens."""
    rng = np.random.RandomState(seed)
    cum = np.cumsum(rng.dirichlet(np.ones(vocab) * 0.05, size=vocab),
                    axis=1)
    steps = -(-n_tokens // chains)
    out = np.empty((chains, steps), np.int64)
    tok = np.zeros(chains, np.int64)
    u = rng.random_sample((steps, chains))
    for i in range(steps):
        tok = np.minimum((cum[tok] < u[i][:, None]).sum(1), vocab - 1)
        out[:, i] = tok
    return out.reshape(-1)[:n_tokens]


def _warmup_cosine_lr(step, peak=3e-4, warmup=10, t_max=40):
    """The rate the scheduler of phase train_loop gives at ``step`` (its
    last_epoch), in closed form: linear from 0 over the warm-up, then
    the cosine, whose own epoch is the number of outer steps at or past
    the warm-up."""
    if step < warmup:
        return peak * step / warmup
    return peak * (1 + np.cos(np.pi * (step - warmup + 1) / t_max)) / 2


def phase_train_loop(cfg1b, batch=8, seq=1024, steps=40, save_at=30,
                     dev="cuda"):
    """examples/train_gpt2.py's flow on the port at Llama-1B's full width
    in bf16, ``cfg1b``'s depth (module docstring, phase 27): AdamW under a
    warm-up-cosine schedule with global-norm clipping, the checkpoint and
    its resume, save/load, evaluate, fit with resume, AMP and the
    scaler."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW, lr
    cfg = cfg1b
    L = cfg.num_hidden_layers
    corpus = synthetic_corpus(512, batch * seq * 50)

    def sample_batch(step):
        rng = np.random.RandomState(step)
        idx = rng.randint(0, corpus.size - seq, batch)
        return torch.from_numpy(np.stack(
            [corpus[i:i + seq] for i in idx])).to(dev)

    def build(seed):
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=seed)
        for name, p in model.named_parameters():
            p.param_name = name          # what apply_decay_param_fun sees
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=40),
                                warmup_steps=10, start_lr=0.0, end_lr=3e-4)
        opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                    weight_decay=0.01,
                    apply_decay_param_fun=lambda n: "norm" not in n,
                    grad_clip=pnn.ClipGradByGlobalNorm(1.0))
        m = Model(model)
        m.prepare(opt, LlamaPretrainingCriterion(cfg))
        return model, opt, sched, m

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def train_step(model, opt, sched, step):
        """One step of the flow; opt.step()'s two halves (the clip and
        the updates) are called apart to put an event between them."""
        want = _warmup_cosine_lr(step)
        if abs(opt.get_lr() - want) > 1e-12 * 3e-4:
            raise AssertionError(f"[train_loop] step {step}: lr "
                                 f"{opt.get_lr()!r}, closed form {want!r}")
        ids = sample_batch(step)
        t0 = time.perf_counter()
        ev[0].record()
        _, loss = model(ids, labels=ids)
        loss.backward()
        ev[1].record()
        pgs = opt._clipped()
        ev[2].record()
        opt._apply(pgs)
        ev[3].record()
        opt.clear_grad()
        sched.step()
        value = loss.item()              # synchronises
        wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return value, wall, [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    tmp = tempfile.mkdtemp(prefix="train_loop_")
    try:
        t0 = time.perf_counter()
        model, opt, sched, m = build(0)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[train_loop] Llama-1B, {L} layers, {n_params / 1e9:.3f} B "
            f"params bf16, AdamW (f32 master weights and moments, decay "
            f"off for norms), LinearWarmup(CosineAnnealingDecay(3e-4, "
            f"T_max=40), 10 steps from 0), ClipGradByGlobalNorm(1.0), "
            f"batches [{batch}, {seq}] of a 512-token Markov corpus; built "
            f"in {time.perf_counter() - t0:.1f} s")
        wrappers = _counted(TRAIN_KERNELS)
        torch.cuda.reset_peak_memory_stats()
        losses, walls, parts = [], [], []
        ckpt_dir = os.path.join(tmp, "step_30")
        for step in range(steps):
            if step == save_at:
                t0 = time.perf_counter()
                m.save_checkpoint(ckpt_dir, epoch=0)
                save_s = time.perf_counter() - t0
            loss, wall, part = train_step(model, opt, sched, step)
            losses.append(loss)
            walls.append(wall)
            parts.append(part)
        launches = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = {"rms_norm": 1, "rms_norm_dx": 1, "rms_norm_residual": 2 * L,
                "rms_norm_residual_dh": 2 * L, "swiglu": L, "swiglu_bwd": L,
                "flash_attention_fwd": L, "flash_attention_dkv": L,
                "flash_attention_dq": L, "chunk_stats": 0,
                "chunk_dlogits": 0}
        per_step = {k: v / steps for k, v in launches.items()}
        if per_step != want:
            raise AssertionError(f"[train_loop] launches per step "
                                 f"{per_step} != {want}")
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        if not (all(np.isfinite(losses)) and last < first - 0.15):
            raise AssertionError(f"[train_loop] loss did not drop: {first} "
                                 f"-> {last} ({losses})")
        step_ms = Timing(walls[5:])
        fb, clip, upd = (Timing([p[i] for p in parts[5:]])
                         for i in range(3))
        tokens = batch * seq
        log(f"[train_loop] {steps} steps: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, mean of the first 5 {first:.4f}, of the "
            f"last 5 {last:.4f} (bar: a drop of 0.15); lr of every step "
            f"equal to the closed form")
        log(f"[train_loop] step {step_ms:.2f} ms (host clock, median "
            f"[least-greatest] of steps 5-{steps - 1}), "
            f"{tokens / (step_ms / 1e3):.0f} tokens/s; by part (CUDA "
            f"events): forward+backward {fb:.2f} ms, clip {clip:.2f} ms, "
            f"update {upd:.2f} ms ({100 * upd / step_ms:.1f}% of the step); "
            f"peak memory {peak:.2f} GB")
        log(f"[train_loop] launches per step {per_step}")
        # the resume: a fresh model and optimizer from the committed
        # checkpoint repeat the uninterrupted steps 30-39
        del model, opt, sched, m
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model, opt, sched, m = build(1)
        if dckpt.latest_valid_checkpoint(tmp) != ckpt_dir:
            raise AssertionError("[train_loop] the checkpoint is not the "
                                 "newest valid one")
        if m.load_checkpoint(ckpt_dir) != 0 or opt._step_count != save_at:
            raise AssertionError("[train_loop] load_checkpoint: epoch or "
                                 "@step not restored")
        load_s = time.perf_counter() - t0
        resumed = [train_step(model, opt, sched, s)[0]
                   for s in range(save_at, steps)]
        gap = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                      losses[save_at:]))
        bitwise = resumed == losses[save_at:]
        # no port kernel uses atomics; a resumed run repeats its losses
        # bit for bit unless a library call does not (reported); the
        # bound is bf16's noise after 10 steps, far below what a lost
        # slot, master weight or schedule position does (0.05 and more)
        if gap > 2e-3:
            raise AssertionError(f"[train_loop] resumed losses {resumed} vs "
                                 f"{losses[save_at:]}")
        ck_gb = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                    for f in os.listdir(ckpt_dir)) / 1e9
        log(f"[train_loop] resume from step_30 (a committed checkpoint of "
            f"{ck_gb:.2f} GB: weights, master weights, moments, beta "
            f"powers, the schedule, @step): save {save_s:.1f} s, fresh "
            f"model + load {load_s:.1f} s; steps 30-39 repeat the "
            f"uninterrupted losses bit for bit: {bitwise} (largest "
            f"relative gap {gap:.3g}, limit 2e-3)")
        shutil.rmtree(ckpt_dir)
        # save/load and predict; evaluate on held-out batches
        probe = TensorDataset([sample_batch(10_000)[:2]])
        logits = m.predict(probe, batch_size=2)[0]
        m.save(os.path.join(tmp, "final"), training=False)
        other = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=2)
        om = Model(other)
        om.load(os.path.join(tmp, "final"))
        if not torch.equal(om.predict(probe, batch_size=2)[0], logits):
            raise AssertionError("[train_loop] save/load: predict differs")
        del other, om, logits
        held = torch.cat([sample_batch(20_000 + i) for i in range(4)])
        ev_loss = m.evaluate(TensorDataset([held, held]), batch_size=batch,
                             verbose=0)["loss"][0]
        if not (np.isfinite(ev_loss) and ev_loss < losses[0]):
            raise AssertionError(f"[train_loop] evaluate: {ev_loss} vs the "
                                 f"first loss {losses[0]}")
        log(f"[train_loop] Model.save/load (.pdparams): predict's logits "
            f"equal; evaluate on 4 held-out batches: loss {ev_loss:.4f} "
            f"(the first step's {losses[0]:.4f})")
        del model, opt, sched, m, held
        torch.cuda.empty_cache()
        fit_res = _train_loop_fit(cfg, tmp, dev, layers=L)
        amp_res = _train_loop_amp(cfg, dev, layers=L)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(losses=losses, step_ms=step_ms, parts=dict(
        forward_backward=fb, clip=clip, update=upd), peak_gb=peak,
        launches=launches, resume_gap=gap, resume_bitwise=bitwise,
        save_s=save_s, load_s=load_s, checkpoint_gb=ck_gb,
        eval_loss=ev_loss, fit=fit_res, amp=amp_res)


def _train_loop_fit(cfg1b, tmp, dev, layers=2, rows=6, seq=257):
    """fit at Llama-1B width and depth ``layers`` in bf16 with SGD: one
    epoch with ``save_dir``, then a new Model resumes to two; its
    weights must equal an uninterrupted two-epoch fit's (shuffled
    batches: a loader fit builds seeds an epoch's order with its
    number)."""
    import dataclasses

    import torch
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import SGD
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    ids = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (rows + 2, seq))).to(dev)
    train = TensorDataset([ids[:rows], ids[:rows]])
    held = TensorDataset([ids[rows:], ids[rows:]])

    def make(seed):
        net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                               seed=seed)
        m = Model(net)
        m.prepare(SGD(1e-2, parameters=net.parameters()),
                  LlamaPretrainingCriterion(cfg))
        return net, m

    save_dir = os.path.join(tmp, "fit")
    t0 = time.perf_counter()
    net, m = make(0)
    m.fit(train, held, batch_size=2, epochs=1, save_dir=save_dir,
          keep_last_n=1, verbose=0)
    names = sorted(os.listdir(save_dir))
    want_names = ["epoch_0.pdopt", "epoch_0.pdparams", "goodput.json",
                  "step_0"]
    if names != want_names or not dckpt.is_committed(
            os.path.join(save_dir, "step_0")):
        raise AssertionError(f"[train_loop fit] save_dir holds {names}, "
                             f"not {want_names} with step_0 committed")
    del net, m
    net, m = make(1)
    m.fit(train, held, batch_size=2, epochs=2, save_dir=save_dir,
          keep_last_n=1, resume=True, verbose=0)
    resumed = [s["epoch"] for s in m._epoch_summaries]
    got = {k: v.clone() for k, v in net.state_dict().items()}
    del net, m
    net, m = make(0)
    m.fit(train, held, batch_size=2, epochs=2, verbose=0)
    same = all(torch.equal(got[k], v) for k, v in net.state_dict().items())
    steps = sorted(n for n in os.listdir(save_dir) if n.startswith("step_"))
    # keep_last_n=1: the resumed fit's step_1 replaced step_0
    if resumed != [1] or not same or steps != ["step_1"]:
        raise AssertionError(f"[train_loop fit] resumed epochs {resumed}, "
                             f"weights equal {same}, steps kept {steps}")
    log(f"[train_loop] fit at depth {layers}: 1 epoch with save_dir "
        f"(committed step_N, epoch_N.pdparams/.pdopt, keep_last_n=1), then "
        f"fit(epochs=2, resume=True) ran epoch 1 only and its weights equal "
        f"an uninterrupted 2-epoch fit's bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    del net, m, ids
    torch.cuda.empty_cache()
    return dict(resumed_epochs=resumed, equal=same)


def _train_loop_amp(cfg1b, dev, layers=2, seq=128):
    """AMP at Llama-1B width and depth ``layers``, f32 parameters, on the
    card against the CPU: one ``train_batch`` at O1 (grads kept) and one
    at O2 (bf16 parameters, f32 master copies); then a GradScaler step
    with an inf in one gradient (skipped, scale halved, weights
    untouched) and a clean one."""
    import dataclasses

    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import SGD
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(cfg1b, num_hidden_layers=layers)
    template = LlamaForCausalLM(cfg, device=dev, seed=11)
    ids = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (1, seq)))
    out = {}
    for level in ("O1", "O2"):
        for name in ("cpu", dev):
            net = _twin(template, name)
            m = Model(net)
            m.prepare(SGD(1e-3, parameters=net.parameters()),
                      LlamaPretrainingCriterion(cfg), amp_configs=level)
            t = ids.to(name)
            loss = m.train_batch([t], t, update=False)[0]
            grads = convert.grads_to_numpy(net)
            m._optimizer.step()
            dtypes = {p.dtype for p in net.parameters()}
            masters = len(m._optimizer._master_weights)
            out[level, name] = (loss, grads, convert.to_numpy_state_dict(net),
                                dtypes, masters)
            del net, m
    lines = []
    for level in ("O1", "O2"):
        (l0, g0, w0, d0, n0), (l1, g1, w1, d1, n1) = out[level, "cpu"], \
            out[level, dev]
        want_dt = {torch.float32} if level == "O1" else {torch.bfloat16}
        if d0 != want_dt or d1 != want_dt or n1 != (
                0 if level == "O1" else len(w1)):
            raise AssertionError(f"[train_loop amp] {level}: parameter "
                                 f"dtypes {d1}, {n1} master copies")
        # bf16 matmuls on both sides, summed in other orders: the loss
        # within 2e-3 of itself, each grad within 5e-2 of its norm
        worst = max(float(np.linalg.norm(g1[k] - g0[k])
                          / max(np.linalg.norm(g0[k]), 1e-30)) for k in g0)
        if abs(l1 - l0) > 2e-3 * abs(l0) or worst > 5e-2:
            raise AssertionError(f"[train_loop amp] {level}: loss card {l1} "
                                 f"vs CPU {l0}, worst grad error {worst:.3g}")
        lines.append(f"{level} loss card {l1:.5f} vs CPU {l0:.5f}, worst "
                     f"grad error {worst:.3g}")
    # the scaler on the card: an inf in one gradient skips the step
    net = _twin(template, dev)
    del template
    opt = SGD(1e-3, parameters=net.parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=1)
    t = ids.to(dev)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    _, loss = net(t, labels=t)
    scaler.scale(loss).backward()
    next(net.parameters()).grad[0, 0] = float("inf")
    scaler.step(opt)
    opt.clear_grad()
    untouched = all(torch.equal(before[k], v)
                    for k, v in net.state_dict().items())
    scale_after_inf = scaler.get_loss_scaling()
    _, loss = net(t, labels=t)
    scaler.scale(loss).backward()
    scaler.step(opt)
    moved = not torch.equal(before["lm_head.weight"],
                            net.state_dict()["lm_head.weight"])
    if not (untouched and scale_after_inf == 2.0 ** 9 and moved
            and scaler.get_loss_scaling() == 2.0 ** 10):
        raise AssertionError(f"[train_loop amp] scaler: untouched "
                             f"{untouched}, scale {scale_after_inf} then "
                             f"{scaler.get_loss_scaling()}, moved {moved}")
    lines.append("GradScaler: an inf in one grad skipped the step (weights "
                 "untouched), the scale went 1024 -> 512, a clean step "
                 "moved the weights and grew it back to 1024")
    log(f"[train_loop] AMP at depth {layers}, [1, {seq}], card vs CPU: "
        + "; ".join(lines))
    del net, opt
    torch.cuda.empty_cache()
    return lines


# ---- the Qwen2-MoE slice -----------------------------------------------------

# the grouped-matmul kernels and the kernels a MoE path may launch
PREEMPT_WINDOWS = 16       # 1025-token windows: 4 steps an epoch at batch 4
PREEMPT_BATCH = 4
PREEMPT_AT = 7             # the SIGTERM after optimizer step 7: step 2 of
                           # epoch 1, not an epoch boundary
PREEMPT_SEQ = 1025
PREEMPT_LAYERS = 1         # Llama-1B's width at depth 1 (2 until the sep
                           # cases came in: PERF.md section 4)


def byte_stream(root, n_bytes):
    """The first ``n_bytes`` of the repository's own ``.py`` and ``.md``
    files, concatenated in path order, as byte ids (0-255)."""
    chunks, have = [], 0
    for dirpath, dirnames, filenames in os.walk(root):
        # in place, so the walk descends in name order and skips these
        dirnames[:] = sorted(d for d in dirnames if not d.startswith((
            ".", "_build", "chiprun_out", "__pycache__")))
        for name in sorted(filenames):
            if name.endswith((".py", ".md")):
                with open(os.path.join(dirpath, name), "rb") as f:
                    chunks.append(f.read())
                have += len(chunks[-1])
        if have >= n_bytes:
            break
    data = np.frombuffer(b"".join(chunks), np.uint8)[:n_bytes]
    if len(data) < n_bytes:
        raise AssertionError(f"[preempt] {root} holds {len(data)} bytes of "
                             f".py/.md text, fewer than {n_bytes}")
    return data.astype(np.int64)


class ByteWindows(_PortDataset):
    """A map-style dataset of the port's ``io``: window ``i`` of ``seq``
    byte ids, as (input ids, labels)."""

    def __init__(self, stream, seq):
        self.stream = stream
        self.seq = seq

    def __len__(self):
        return len(self.stream) // self.seq

    def __getitem__(self, i):
        w = self.stream[i * self.seq:(i + 1) * self.seq]
        return w, w


def _cuda_settings():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _preempt_fit(data, out, num_workers=2, save_dir=None, resume=None,
                 sigterm_after=None):
    """Llama-1B's width at ``PREEMPT_LAYERS`` in bf16 with AdamW, fit for 2
    epochs over ``data`` (shuffled, ``num_workers`` loader workers, the
    fused linear+CE); every loss read at its step (``log_freq=1``). Returns
    the record of the run (written to ``out`` too, also when ``fit``
    raises): per-step losses with their times, launches of the training
    kernels, epoch summaries, peak memory, the final weights' digest.
    ``sigterm_after``: a real SIGTERM to this process right after that
    optimizer step."""
    import dataclasses
    import hashlib
    import signal

    import torch
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import metrics as pmetrics
    from paddle_tpu_torch.utils import monitor
    cfg = dataclasses.replace(LlamaConfig.llama_1b(),
                              num_hidden_layers=PREEMPT_LAYERS,
                              scan_layers=False)
    net = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    m = Model(net)
    opt = AdamW(1e-4, parameters=net.parameters())
    m.prepare(opt, LlamaPretrainingCriterion(cfg))
    rec = {"t_start": time.time(), "losses": [], "loss_t": []}
    if sigterm_after is not None:
        real_step = opt.step

        def step():
            real_step()
            if opt._step_count == sigterm_after:
                torch.cuda.synchronize()
                rec["t_sigterm"] = time.time()
                os.kill(os.getpid(), signal.SIGTERM)

        opt.step = step

    def hook(r):
        rec["losses"].append(float(r["loss"]))
        rec["loss_t"].append(time.time())

    remove = monitor.register_step_metrics_hook(hook)
    wrappers = _counted(TRAIN_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    try:
        # legacy_save off: the epoch's .pdparams/.pdopt (3.2 GB at this
        # width) are train_loop's fit's to show; here only the committed
        # step_N checkpoints that a resume reads
        m.fit(data, batch_size=PREEMPT_BATCH, epochs=2, shuffle=True,
              num_workers=num_workers, save_dir=save_dir, resume=resume,
              log_freq=1, verbose=0, legacy_save=False)
        digest = hashlib.sha256()
        for k, v in sorted(net.state_dict().items()):
            digest.update(v.detach().contiguous().view(torch.uint8)
                          .cpu().numpy().tobytes())
        rec["digest"] = digest.hexdigest()
    except BaseException as e:
        rec["raised"] = type(e).__name__
        for k in ("checkpoint", "epoch", "step"):
            if hasattr(e, k):
                rec[k] = getattr(e, k)
        raise
    finally:
        torch.cuda.synchronize()
        remove()
        rec.update(
            t_end=time.time(), steps=len(rec["losses"]),
            launches={k: w.launches for k, w in wrappers.items()},
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            epochs=[{k: s[k] for k in ("epoch", "steps", "seconds",
                                       "avg_step_ms", "input_wait_ms")}
                    for s in m._epoch_summaries],
            emergency_save_ms=pmetrics.get_registry().gauge(
                "elastic/emergency_save_ms").value,
            goodput=m._goodput.summary() if m._goodput else None)
        with open(out, "w") as f:
            json.dump(rec, f)
    return rec


def preempt_worker(out_dir):
    """The worker the launcher runs in phase preempt (``chip_smoke.py
    --preempt-worker DIR``): round 0 takes a real SIGTERM after optimizer
    step ``PREEMPT_AT`` and leaves through ``Preempted`` (exit 75); a
    relaunch resumes from ``PADDLE_RESUME_CHECKPOINT``."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the preempt worker needs a CUDA device")
    _cuda_settings()
    rnd = int(os.environ.get("PADDLE_RESTART_ROUND", "0"))
    resume = os.environ.get("PADDLE_RESUME_CHECKPOINT")
    if resume:
        from paddle_tpu_torch.distributed import checkpoint as dckpt
        with open(os.path.join(out_dir, f"resume{rnd}.json"), "w") as f:
            json.dump({"checkpoint": resume,
                       "committed": dckpt.is_committed(resume),
                       "values": dckpt.load_values(resume)}, f)
    data = ByteWindows(np.load(os.path.join(out_dir, "stream.npy")),
                       PREEMPT_SEQ)
    _preempt_fit(data, os.path.join(out_dir, f"round{rnd}.json"),
                 save_dir=os.path.join(out_dir, "ck"), resume=True,
                 sigterm_after=PREEMPT_AT if rnd == 0 else None)
    return 0


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _per_step(tag, rec, want):
    per = {k: v / rec["steps"] for k, v in rec["launches"].items()}
    if per != want:
        raise AssertionError(f"[preempt] {tag}: launches per step {per} != "
                             f"{want}")


def phase_preempt(cfg1b):
    """Phase preempt: the elastic launcher runs a preemptible fit at
    Llama-1B's width (``PREEMPT_LAYERS``) over a map-style dataset of the
    repository's text through two loader workers; a real SIGTERM mid
    epoch 1, the emergency checkpoint, exit 75, the relaunch that
    resumes it; held bit for bit against an uninterrupted run."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    try:
        repo = os.path.dirname(os.path.abspath(__file__))
        stream = byte_stream(repo, PREEMPT_WINDOWS * PREEMPT_SEQ)
        np.save(os.path.join(tmp, "stream.npy"), stream)
        data = ByteWindows(stream, PREEMPT_SEQ)
        L = PREEMPT_LAYERS
        chunks = -(-cfg1b.vocab_size // 1024)
        want = {"rms_norm": 1, "rms_norm_dx": 1,
                "rms_norm_residual": 2 * L, "rms_norm_residual_dh": 2 * L,
                "swiglu": L, "swiglu_bwd": L, "flash_attention_fwd": L,
                "flash_attention_dkv": L, "flash_attention_dq": L,
                "chunk_stats": chunks, "chunk_dlogits": chunks}
        # the launcher: round 0 preempted, round 1 resumed
        t_launch = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--max_preempt_restarts", "1", "--max_restarts", "0",
             "--elastic_timeout", "0", "--log_dir",
             os.path.join(tmp, "log"), "--checkpoint_dir",
             os.path.join(tmp, "ck"), os.path.abspath(__file__),
             "--preempt-worker", tmp],
            cwd=repo, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [repo] + os.environ.get("PYTHONPATH", "").split(
                    os.pathsep)).rstrip(os.pathsep)),
            capture_output=True, text=True, timeout=600)
        launch_s = time.perf_counter() - t_launch
        if proc.returncode != 0:
            logs = ""
            for name in sorted(os.listdir(os.path.join(tmp, "log"))):
                with open(os.path.join(tmp, "log", name)) as f:
                    logs += f.read()[-4000:]
            raise AssertionError(f"[preempt] the launcher exited "
                                 f"{proc.returncode}:\n{proc.stderr}\n{logs}")
        relaunches = proc.stderr.count("relaunching (")
        if (proc.stderr.count("relaunching (preempt 1/1)") != 1
                or relaunches != 1 or "exited rc=" in proc.stderr):
            raise AssertionError(f"[preempt] expected one preemption "
                                 f"relaunch and no crash:\n{proc.stderr}")
        r0, r1, resumed = (_read_json(os.path.join(tmp, n)) for n in (
            "round0.json", "round1.json", "resume1.json"))
        per_epoch = PREEMPT_WINDOWS // PREEMPT_BATCH
        if (r0.get("raised") != "Preempted" or r0.get("epoch") != 1
                or r0.get("step") != PREEMPT_AT - 1 - per_epoch
                or not resumed["committed"]
                or resumed["values"].get("mid_epoch_step") != r0["step"]):
            raise AssertionError(f"[preempt] round 0 ended {r0.get('raised')}"
                                 f" at epoch {r0.get('epoch')} step "
                                 f"{r0.get('step')}; the resume checkpoint "
                                 f"{resumed}")
        # the uninterrupted run, in this process, with 2 workers and none
        ref = _preempt_fit(data, os.path.join(tmp, "ref.json"))
        ref0 = _preempt_fit(data, os.path.join(tmp, "ref0.json"),
                            num_workers=0)
        for tag, rec in (("round 0", r0), ("round 1", r1),
                         ("uninterrupted", ref), ("no workers", ref0)):
            _per_step(tag, rec, want)
        steps = 2 * per_epoch
        if (r0["losses"] + r1["losses"] != ref["losses"]
                or r1.get("digest") != ref["digest"]
                or ref0["losses"] != ref["losses"]
                or ref0["digest"] != ref["digest"]
                or len(ref["losses"]) != steps):
            raise AssertionError(
                f"[preempt] not bit for bit: {r0['steps']} + {r1['steps']} "
                f"steps, losses {r0['losses'] + r1['losses']} against "
                f"{ref['losses']}; digests {r1.get('digest')} "
                f"{ref['digest']} {ref0['digest']}")
        with open(os.path.join(tmp, "ck", "goodput.json")) as f:
            ledger = json.load(f)
        lost0 = ledger["rounds"]["0"]["lost"]
        lost1 = ledger["rounds"]["1"]["lost"]
        if (sorted(ledger["rounds"]) != ["0", "1"]
                or not lost0["emergency_save"] > 0
                or not lost1["reshard"] > 0):
            raise AssertionError(f"[preempt] goodput.json {ledger}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    recover_s = r1["loss_t"][0] - r0["t_sigterm"]
    good = r1["goodput"]
    log(f"[preempt] Llama-1B width, depth {PREEMPT_LAYERS}, bf16, AdamW, "
        f"{len(data)} "
        f"windows of {PREEMPT_SEQ} byte ids of the repository's .py/.md "
        f"text, batch {PREEMPT_BATCH}, shuffled through 2 loader workers; "
        f"the launcher ran {launch_s:.1f} s: round 0 {r0['t_end'] - r0['t_start']:.1f} s "
        f"in fit ({r0['steps']} steps, SIGTERM after step {PREEMPT_AT}, "
        f"Preempted at epoch {r0['epoch']} step {r0['step']}, exit 75), "
        f"round 1 {r1['t_end'] - r1['t_start']:.1f} s in fit ({r1['steps']} "
        f"steps after the resume); one preemption relaunch, no crash")
    log(f"[preempt] elastic/emergency_save_ms {r0['emergency_save_ms']}; "
        f"time to recover (SIGTERM to the first resumed step's loss) "
        f"{recover_s:.3f} s; goodput_frac {good['goodput_frac']} over "
        f"{good['rounds']} rounds, wall {good['wall_s']} s, lost: "
        + ", ".join(f"{k} {good['lost_' + k + '_s']}" for k in (
            "input_wait", "checkpoint_save", "emergency_save", "restart",
            "reshard", "recompile")))
    for tag, rec in (("2 workers", ref), ("no workers", ref0)):
        log(f"[preempt] uninterrupted, {tag}: input_wait_ms by epoch "
            f"{[e['input_wait_ms'] for e in rec['epochs']]}, avg_step_ms "
            f"{[e['avg_step_ms'] for e in rec['epochs']]}, peak memory "
            f"{rec['peak_gb']:.2f} GB")
    log(f"[preempt] resumed losses and final weights equal the "
        f"uninterrupted run's bit for bit (and the run with no workers); "
        f"launches per step exact in all four runs; goodput.json holds "
        f"both rounds ({time.perf_counter() - t0:.1f} s)")
    launches = {k: r0["launches"][k] + r1["launches"][k]
                + ref["launches"][k] + ref0["launches"][k] for k in want}
    return dict(launches=launches, recover_s=recover_s,
                emergency_save_ms=r0["emergency_save_ms"], goodput=good,
                input_wait_ms={"workers_2": [e["input_wait_ms"]
                                             for e in ref["epochs"]],
                               "workers_0": [e["input_wait_ms"]
                                             for e in ref0["epochs"]]})


MOE_KERNELS = ("grouped_matmul", "grouped_matmul_t", "grouped_dw")


def _routed_layout(n_tokens, top_k, n_experts, dev, seed):
    """The group-padded layout of a seeded top-k routing of ``n_tokens``
    tokens (router logits with a per-expert skew, so the groups are
    uneven): (perm, tile_gid, P, the real-row mask [P] bool)."""
    import torch
    from paddle_tpu_torch.ops import moe
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(n_tokens, n_experts, device=dev, generator=gen)
    logits += torch.linspace(1.0, -1.0, n_experts, device=dev)
    gate_idx = torch.topk(logits, top_k, dim=-1).indices
    perm, gid, P = moe.sort_rows_by_expert(gate_idx, n_experts)
    real = torch.zeros(P, dtype=torch.bool, device=dev)
    real[perm.long()] = True
    return perm, gid, P, real


def _group_ends(gid, n_experts, bm=128):
    """Each expert's last padded row + 1 (int32): the offsets of
    torch._grouped_mm."""
    import torch
    e = torch.arange(n_experts, device=gid.device, dtype=torch.int32)
    return (torch.searchsorted(gid, e, right=True) * bm).to(torch.int32)


# (tag, experts, top-k, d, h, dtypes): the wide training shape of
# qwen2_moe_a14b and the MoE bench width
MOE_KERNEL_SHAPES = (("wide", 60, 4, 3584, 1408, ("bf16",)),
                     ("bench", 16, 2, 1024, 1408, ("f32", "bf16")))


def phase_moe_kernels(head_cfg=None, dev="cuda", n_tokens=8196,
                      shapes=MOE_KERNEL_SHAPES):
    """K14 (both modes) and K15 against their plain versions, per element:
    at the wide training shape (qwen2_moe_a14b: P 40576 from a top-4
    routing of 8196 tokens over 60 experts, d 3584, h 1408) in bf16,
    timed; and at the bench width (d 1024, h 1408, 16 experts, top-2 of
    8196 tokens) in f32 and bf16. With ``head_cfg``, K12 and K7-K9 at its
    head layout too (:func:`_qwen2_head_checks`)."""
    import torch
    res = {}
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    for tag, E, k, d, h, dtypes in shapes:
        errs, entries = _grouped_at(tag, E, k, d, h,
                                    [types[t] for t in dtypes], n_tokens,
                                    dev)
        for name, (e16, e32) in errs.items():
            r = res.setdefault(name, {"max_abs_err": 0.0})
            if e16 is not None:
                r["max_abs_err"] = max(r["max_abs_err"], e16)
            if e32 is not None:
                r["max_abs_err_f32"] = max(r.get("max_abs_err_f32", 0.0),
                                           e32)
            if name not in entries:
                continue
            if tag == "wide":
                r.update(entries[name])
            else:
                r["bench"] = entries[name]
    for name, entry in _grouped_decode().items():
        res[name]["decode"] = entry
    if head_cfg is not None:
        _qwen2_head_checks(head_cfg, dev)
    return res


def _grouped_at(tag, E, k, d, h, dtypes, n_tokens, dev,
                log_tag="moe_kernels"):
    """K14 (both modes) and K15 at one routed layout (a seeded top-``k``
    routing of ``n_tokens`` tokens over ``E`` experts, widths d and h) in
    each of ``dtypes``, against their plain versions per element, a
    second launch repeating the bits; bf16 timed beside the plain
    version, torch._grouped_mm and the bound. Returns ({name: (bf16 max
    abs err or None, f32 or None)}, {name: bf16 entry})."""
    import torch
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgmm
    perm, gid, P, real = _routed_layout(n_tokens, k, E, dev, seed=E)
    counts = torch.bincount(gid.long(), minlength=E).tolist()
    log(f"[{log_tag}] {tag}: P {P}, {len(counts)} experts, row tiles per "
        f"expert {min(counts)}..{max(counts)}")
    gen = torch.Generator(device=dev).manual_seed(7 + E)
    errs, entries = {}, {}
    for dtype in dtypes:
        # padding rows are zero in x and in dy, as on the path
        x = torch.randn(P, d, device=dev, generator=gen) * real[:, None]
        dy = torch.randn(P, h, device=dev, generator=gen) * real[:, None]
        w = 0.02 * torch.randn(E, d, h, device=dev, generator=gen)
        x, dy, w = x.to(dtype), dy.to(dtype), w.to(dtype)
        calls = {
            "grouped_matmul": (kgmm.grouped_matmul, (x, w, gid),
                               lambda a, b, g: kgmm.grouped_matmul_reference(
                                   a, b, g)),
            "grouped_matmul_t": (kgmm.grouped_matmul_t, (dy, w, gid),
                                 lambda a, b, g: kgmm.grouped_matmul_reference(
                                     a, b, g, True)),
            "grouped_dw": (kgmm.grouped_dw, (x, dy, gid, E),
                           kgmm.grouped_dw_reference),
        }
        for name, (fn, args, plain) in calls.items():
            out = fn(*args)
            ref = plain(*args)
            mag = plain(*(a.float().abs() if torch.is_tensor(a)
                          and a.is_floating_point() else a for a in args))
            torch.cuda.synchronize()
            # every output element is written once, in one order
            if not torch.equal(fn(*args), out):
                raise AssertionError(f"{name} {tag} {dtype}: a second "
                                     f"launch on the same inputs gave "
                                     f"other bits")
            # per element: both sides take f32 products and round once;
            # the sums come in another order, 1e-5 of the sum of |terms|,
            # which in bf16 may flip the rounding: one ulp
            ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
            err, worst = check_close(
                f"{name} {tag} {dtype}", out, ref,
                ulp * ref.float().abs() + 1e-5 * mag + 1e-6)
            del out, ref, mag
            log(f"[{log_tag}] {name} {tag} {dtype}: max abs err {err:.3g} "
                f"(limit {'1 ulp of |ref| + ' if ulp else ''}1e-5 of the "
                f"sum of |terms|, worst err/limit {worst:.3g}); a second "
                f"launch repeats it bit for bit")
            e16, e32 = errs.get(name, (None, None))
            errs[name] = (err, e32) if dtype == torch.bfloat16 \
                else (e16, err)
            if dtype != torch.bfloat16:
                continue
            ms = time_ms(fn, args, iters=5)
            # the plain version reads its run boundaries on the host:
            # eager, host included
            plain_ms = eager_ms(plain, args, iters=2)
            # each mode reads two of x [P, d], dy [P, h] and the bank
            # [E, d, h] and writes the third
            n_bytes = (P * d + P * h + E * d * h) * 2
            b_ms, b_by = bound(n_bytes, 2.0 * P * d * h, PEAK_BF16)
            lib = _grouped_mm_ms(name, args, E)
            log(f"[{log_tag}] {name} {tag}: kernel {ms:.4f} ms "
                f"({_rate(2.0 * P * d * h, ms, b_ms)}) plain {plain_ms:.4f}"
                f" ms (eager) library "
                f"{'none' if lib is None else f'{lib:.4f} ms'} bound "
                f"{b_ms:.4f} ms ({b_by})")
            entries[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                                 bound_ms=b_ms, bound_by=b_by,
                                 shape=f"P {P} d {d} h {h} E {E} bf16",
                                 design=WGMMA_DESIGN)
        del x, dy, w
        torch.cuda.empty_cache()
    return errs, entries


def _grouped_decode(slots=8, top_k=4, n_experts=60, d=3584, h=1408,
                    dev="cuda", tag="moe_kernels"):
    """K14 and K14 transposed at the layout of a serve_moe decode forward:
    ``slots`` tokens routed top-``top_k`` over ``n_experts`` experts give
    32 real rows in P = (1 + 60) * 128 = 7808 (every expert owns a padding
    tile), at qwen2_moe_a14b's widths; bf16, held against the plain
    versions, timed beside torch._grouped_mm. The bound counts what the
    call must move and compute: all of x, dy and the bank, and the
    products of every row (the kernels do not skip padding tiles)."""
    import torch
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgmm
    perm, gid, P, real = _routed_layout(slots, top_k, n_experts, dev,
                                        seed=3)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn(P, d, device=dev, generator=gen)
         * real[:, None]).bfloat16()
    dy = (torch.randn(P, h, device=dev, generator=gen)
          * real[:, None]).bfloat16()
    w = (0.02 * torch.randn(n_experts, d, h, device=dev,
                            generator=gen)).bfloat16()
    res = {}
    for name, fn, args, t in (("grouped_matmul", kgmm.grouped_matmul,
                               (x, w, gid), False),
                              ("grouped_matmul_t", kgmm.grouped_matmul_t,
                               (dy, w, gid), True)):
        out = fn(*args)
        ref = kgmm.grouped_matmul_reference(*args, t)
        mag = kgmm.grouped_matmul_reference(args[0].float().abs(),
                                            w.float().abs(), gid, t)
        err, worst = check_close(f"{name} decode", out, ref,
                                 BF16_ULP * ref.float().abs() + 1e-5 * mag
                                 + 1e-6)
        if not torch.equal(fn(*args), out):
            raise AssertionError(f"{name} decode: a second launch on the "
                                 f"same inputs gave other bits")
        ms = time_ms(fn, args, iters=5)
        # the plain version reads its run boundaries on the host: eager
        plain_ms = eager_ms(lambda a, b, g, t=t:
                            kgmm.grouped_matmul_reference(a, b, g, t),
                            args, iters=2)
        lib = _grouped_mm_ms(name, args, n_experts)
        b_ms, b_by = bound((P * d + P * h + n_experts * d * h) * 2,
                           2.0 * P * d * h, PEAK_BF16)
        shape = (f"P {P} ({int(real.sum())} real rows) d {d} h {h} "
                 f"E {n_experts} bf16")
        log(f"[{tag}] {name} decode {shape}: kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms (eager) "
            f"library {'none' if lib is None else f'{lib:.4f} ms'} bound "
            f"{b_ms:.4f} ms ({b_by}); max abs err {err:.3g} (worst "
            f"err/limit {worst:.3g}); a second launch repeats it bit for "
            f"bit")
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, shape=shape,
                         max_abs_err=err)
        del out, ref, mag
    del x, dy, w
    torch.cuda.empty_cache()
    return res


def _qwen2_head_checks(cfg, dev):
    """K12 and K7-K9 at Qwen2's head layout, 28 query heads over 4 kv
    heads (rep 7, which does not divide K12's 64-row CTA: its last row is
    unused), against their plain versions per element, in bf16 and f32:
    K12 on the serve phase's mixed batch and at serve_moe's decode step
    (one token a slot, its keys split 8 ways; :func:`_ragged_at`), K7-K9
    at [1, 2049] tokens."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(99)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    _ragged_at("qwen2", cfg.num_attention_heads, cfg.num_key_value_heads,
               cfg.head_dim, dev, seed=99, log_tag="moe_kernels")
    flash_checks(1, 2049, cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim, rand)
    torch.cuda.empty_cache()


def _grouped_mm_ms(name, args, n_experts):
    """torch._grouped_mm on the same function, offsets at the padded group
    ends, or None where this PyTorch does not take the shapes (the
    yardstick only: the port never calls it)."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    ends = _group_ends(args[2], n_experts)
    try:
        if name == "grouped_matmul":
            x, w, _ = args
            call, cargs = (lambda a, b, o: fn(a, b, offs=o)), (x, w, ends)
        elif name == "grouped_matmul_t":
            dy, w, _ = args
            call, cargs = ((lambda a, b, o: fn(a, b.transpose(-2, -1),
                                                offs=o)), (dy, w, ends))
        else:
            x, dy, _, _ = args
            call, cargs = ((lambda a, b, o: fn(a.t(), b, offs=o)),
                           (x, dy, ends))
        call(*cargs)
        torch.cuda.synchronize()
        return time_ms(call, cargs, iters=5)
    except Exception as e:      # noqa: BLE001 - a yardstick, not the path
        log(f"[moe_kernels] torch._grouped_mm does not take {name}'s "
            f"shapes here: {str(e).splitlines()[0][:160]}")
        return None


def _moe_launch_counts(cfg, forwards):
    """Launches of a serving run of ``forwards`` forwards (the unfused
    stack: two norms a layer and the final one; the shared expert's
    SwiGLU; three grouped matmuls a MoE layer)."""
    L = cfg.num_hidden_layers
    return {"rms_norm": (2 * L + 1) * forwards, "swiglu": L * forwards,
            "ragged_paged_attention": L * forwards,
            "grouped_matmul": 3 * L * forwards, "grouped_matmul_t": 0,
            "grouped_dw": 0}


def phase_serve_moe(cfg, dev="cuda"):
    """qwen2_moe_a14b at full width and half its depth (14 of 28 layers),
    dropless, bf16, through the engine: the Llama serve phase's engine and
    traffic."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import Qwen2MoeForCausalLM
    cfg = dataclasses.replace(cfg, moe_dropless=True, num_hidden_layers=14)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Qwen2MoeForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                seed=0)
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L = cfg.num_hidden_layers
    log(f"[serve_moe] qwen2_moe_a14b {L} layers, {n_params / 1e9:.2f} B "
        f"params bf16 ({cfg.num_experts} experts, top-"
        f"{cfg.num_experts_per_tok}, dropless), built in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ContinuousBatchingEngine(model, num_slots=8, page_size=16,
                                   max_len=2048, prefill_chunk=256,
                                   decode_chunk=8, prefix_cache=False,
                                   device=dev)
    rng = np.random.RandomState(42)
    eng.add_request(rng.randint(0, cfg.vocab_size, 16), 4)
    eng.run()
    prompt_lens = rng.permutation(np.linspace(64, 1500, 12).astype(int))
    n_new = 32
    for n in prompt_lens:
        eng.add_request(rng.randint(0, cfg.vocab_size, int(n)), n_new)
    names = ("rms_norm", "swiglu", "ragged_paged_attention") + MOE_KERNELS
    fw0, st0 = eng._stats["forwards"], eng._stats["unified_steps"]
    wrappers = _counted(names)
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = eng._stats["forwards"] - fw0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(done) != 12 or any(len(r.tokens) != n_new for r in done):
        raise AssertionError(f"{len(done)} of 12 requests completed with "
                             f"{[len(r.tokens) for r in done]} tokens")
    if len(eng._free_pages) != eng.num_pages - 1:
        raise AssertionError("pages were not all returned after the run")
    want = _moe_launch_counts(cfg, forwards)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for "
                             f"{forwards} forwards")
    log(f"[serve_moe] 12 requests (prompts {sorted(prompt_lens.tolist())}, "
        f"{n_new} new each) in {wall:.2f} s: {12 * n_new / wall:.1f} "
        f"generated tok/s, {eng._stats['unified_steps'] - st0} steps, "
        f"{forwards} forwards, peak memory {peak:.2f} GB")
    log(f"[serve_moe] launches {launches} (per forward: {2 * L + 1} "
        f"rms_norm, {L} swiglu, {L} attention, {3 * L} grouped_matmul; a "
        f"decode forward routes {8 * cfg.num_experts_per_tok} rows into "
        f"P = {(1 + cfg.num_experts) * 128}, a tile for every expert)")

    prof = _profile_two_requests("serve_moe", eng, cfg.vocab_size)
    del eng
    torch.cuda.empty_cache()
    gen = generate_moe(model)
    del model
    torch.cuda.empty_cache()
    return dict(wall_s=wall, tok_s=12 * n_new / wall, peak_gb=peak,
                launches=launches, profile=prof, generate=gen)


def moe_bench_config():
    """bench.py's _moe_bench_config(on_tpu=True) (bench.py:2042-2062), the
    JAX bench's MoE MFU step, uncut."""
    from paddle_tpu_torch.models import Qwen2MoeConfig
    return Qwen2MoeConfig(
        vocab_size=32000, hidden_size=1024, num_hidden_layers=12,
        num_attention_heads=8, num_key_value_heads=4,
        intermediate_size=2816, max_position_embeddings=4096,
        rope_theta=10000.0, num_experts=16, num_experts_per_tok=2,
        moe_intermediate_size=1408, shared_expert_intermediate_size=2816,
        capacity_factor=2.0, moe_dropless=True, use_recompute=True,
        full_save_interval=2, router_aux_loss_coef=0.0, scan_layers=False)


def _moe_train_want(cfg):
    """Launches per step of the MoE training step, as derived from the
    code: every layer's input norm is plain (K1, K2 in the backward) and
    its post-attention pair fused (K3, K4), plus the final norm; one
    SwiGLU (the shared expert), one attention and three grouped matmuls a
    layer; a recomputed layer re-runs its whole forward in the backward
    (K1, K3, K5, K7 and three K14); each grouped matmul's backward is one
    K14 transposed and one K15."""
    L = cfg.num_hidden_layers
    fs = max(int(cfg.full_save_interval), 0)
    lr = sum(1 for i in range(L) if not (fs and i % fs == fs - 1)) \
        if cfg.use_recompute else 0
    return {"rms_norm": L + 1 + lr, "rms_norm_dx": L + 1,
            "rms_norm_residual": L + lr, "rms_norm_residual_dh": L,
            "swiglu": L + lr, "swiglu_bwd": L, "flash_attention_fwd": L + lr,
            "flash_attention_dkv": L, "flash_attention_dq": L,
            "chunk_stats": 0, "chunk_dlogits": 0,
            "grouped_matmul": 3 * (L + lr), "grouped_matmul_t": 3 * L,
            "grouped_dw": 3 * L}


def phase_moe_train(tag, cfg, batch=4, seq=2048, warmup=2, steps=5,
                    dev="cuda"):
    """The JAX bench's MoE step (bench.py:_moe_train_bench) on the port:
    forward and backward of the labelled loss with the grads cleared and
    no optimizer, bf16, seeded random weights, token ids [batch, seq + 1]
    from RandomState(0) rolled per step; the fused carry and the
    dots_saveable policy (the defaults). The model-FLOP share counts
    activated FLOPs as bench.py does."""
    import torch
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.models import Qwen2MoeForCausalLM
    want_flags = {"FLAGS_fused_rmsnorm_residual": True,
                  "FLAGS_recompute_policy": "dots_saveable"}
    got = flags.get_flags(list(want_flags))
    if got != want_flags:
        raise AssertionError(f"{tag} needs {want_flags}, not {got}")
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                seed=0)
    torch.cuda.synchronize()
    n_total = sum(p.numel() for p in model.parameters())
    L, d = cfg.num_hidden_layers, cfg.hidden_size
    per_expert = 3 * d * cfg.moe_intermediate_size
    n_active = n_total - L * (cfg.num_experts
                              - cfg.num_experts_per_tok) * per_expert
    log(f"[{tag}] Qwen2-MoE H {d}, {L} layers, {cfg.num_experts} experts "
        f"top-{cfg.num_experts_per_tok}: {n_total / 1e9:.3f} B params "
        f"({n_active / 1e9:.3f} B active) bf16, dropless, recompute "
        f"(full_save_interval {cfg.full_save_interval}), built in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    step_ids = [torch.from_numpy(np.roll(ids, i, axis=1)).to(dev)
                for i in range(warmup + steps)]

    def step(t):
        _, loss = model(t, labels=t)
        loss.backward()
        for p in model.parameters():
            p.grad = None
        return loss.item()

    torch.cuda.reset_peak_memory_stats()
    losses = [step(step_ids[i]) for i in range(warmup)]
    # the MoE block (routing, gathers, K14, K14 transposed, K15) forward
    # and backward with no host synchronisation: any would raise here
    xin = torch.randn(1, batch * seq, d, device=dev, dtype=torch.bfloat16,
                      requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.layers[0].mlp(xin).float().square().mean().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del xin
    for p in model.parameters():
        p.grad = None
    log(f"[{tag}] the MoE block's forward and backward ran with no host "
        f"synchronisation (sync debug mode 'error')")
    wrappers = _counted(TRAIN_KERNELS + MOE_KERNELS)
    times = []
    for i in range(warmup, warmup + steps):
        t0 = time.perf_counter()
        losses.append(step(step_ids[i]))   # .item() synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    expect = _init_loss(cfg)
    if abs(losses[0] - expect) > 0.5:
        raise AssertionError(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                             f"of ln(vocab) + s2/2 = {expect:.4f}")
    want = _moe_train_want(cfg)
    per_step = {k: v / steps for k, v in launches.items()}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step} != {want}")
    t = Timing(times)
    tokens = batch * seq
    flops = 6.0 * n_active * tokens + 12.0 * L * batch * seq * seq * d
    log(f"[{tag}] {steps} steps of [{batch}, {seq + 1}] tokens: step "
        f"{t:.1f} ms (median [least-greatest]), {tokens / (t / 1e3):.0f} "
        f"tokens/s, activated FLOPs {flops / 1e12:.1f} TFLOP a step = "
        f"{100 * flops / (t / 1e3) / PEAK_BF16:.1f}% of "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s, peak memory {peak:.2f} GB")
    log(f"[{tag}] losses {[round(x, 4) for x in losses]} (predicted from "
        f"the init: {expect:.4f})")
    log(f"[{tag}] launches per step {per_step}")
    prof = _profile(tag, lambda: step(step_ids[-1]))
    del model, step_ids
    torch.cuda.empty_cache()
    return dict(step_ms=t, tokens_per_s=tokens / (t / 1e3),
                mfu=flops / (t / 1e3) / PEAK_BF16, peak_gb=peak,
                losses=losses, launches=launches, profile=prof)


def phase_moe_parity(bench_cfg, layers=2, dev="cuda"):
    """The bench width at depth ``layers`` in f32, the card (kernels)
    against the CPU (plain versions) from the same weights: (a) greedy
    serving streams; (b) a labelled forward and backward, dropless with
    recompute: the loss and every gradient; (c) the capacity path's
    loss."""
    import dataclasses

    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import Qwen2MoeForCausalLM
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(bench_cfg, num_hidden_layers=layers)
    weights = Qwen2MoeForCausalLM(cfg, device="cpu", seed=8).state_dict()

    def build(name, **kw):
        model = Qwen2MoeForCausalLM(dataclasses.replace(cfg, **kw),
                                    device=name)
        model.load_state_dict(weights)
        return model

    # (a) greedy streams
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (100, 37, 64, 9)]
    streams, models = {}, {}
    for name in ("cpu", dev):
        models[name] = build(name).eval()
        eng = ContinuousBatchingEngine(models[name], num_slots=4,
                                       page_size=16, max_len=256,
                                       prefill_chunk=128, decode_chunk=4,
                                       device=name)
        for p in prompts:
            eng.add_request(p, 12)
        streams[name] = [r.tokens for r in sorted(
            eng.run(), key=lambda r: r.request_id)]
    for i, (g, c) in enumerate(zip(streams[dev], streams["cpu"])):
        if g == c:
            continue
        j = next(k for k, (a, b) in enumerate(zip(g, c)) if a != b)
        gap = _top2_gap(models["cpu"], list(prompts[i]) + c[:j])
        if gap >= 1e-3:
            raise AssertionError(
                f"moe_parity (a): request {i} diverges at token {j} with a "
                f"CPU top-2 gap of {gap:.3g}: {g} vs {c}")
        log(f"[moe_parity] request {i} diverges at token {j} on a near tie "
            f"(CPU top-2 gap {gap:.3g} < 1e-3)")
    same = sum(g == c for g, c in zip(streams[dev], streams["cpu"]))
    log(f"[moe_parity] (a) H {cfg.hidden_size}, {layers} layers, f32, 4 "
        f"greedy streams of 12 tokens: {same}/4 identical on card and CPU")
    del models
    # (b) dropless with recompute, (c) the capacity path's loss
    ids = torch.from_numpy(np.random.RandomState(13).randint(
        0, cfg.vocab_size, (1, 300)))
    out = {}
    for name in ("cpu", dev):
        model = build(name)
        t = ids.to(name)
        _, loss = model(t, labels=t)
        loss.backward()
        grads = convert.grads_to_numpy(model)
        cap = build(name, moe_dropless=False, use_recompute=False)
        with torch.no_grad():
            cap_loss = cap(t, labels=t)[1].item()
        out[name] = (loss.item(), grads, cap_loss)
        del model, cap
    (l0, g0, c0), (l1, g1, c1) = out["cpu"], out[dev]
    # f32 on both sides: as train_parity, the loss within 1e-5 of itself
    # and every gradient within 1e-4 (whole-tensor relative)
    if abs(l1 - l0) > 1e-5 * abs(l0) or abs(c1 - c0) > 1e-5 * abs(c0):
        raise AssertionError(f"moe_parity: losses {l1}, {c1} on the card vs "
                             f"{l0}, {c0} on the CPU")
    worst_g = max(float(np.linalg.norm(g1[k] - g0[k])
                        / max(np.linalg.norm(g0[k]), 1e-30)) for k in g0)
    if worst_g > 1e-4:
        raise AssertionError(f"moe_parity (b): a gradient's relative error "
                             f"is {worst_g:.3g}")
    log(f"[moe_parity] (b) dropless + recompute, [1, 300]: loss card "
        f"{l1:.6f} vs CPU {l0:.6f}; {len(g0)} grads, worst relative error "
        f"{worst_g:.3g} (limit 1e-4); (c) capacity path loss card "
        f"{c1:.6f} vs CPU {c0:.6f}")
    torch.cuda.empty_cache()
    return worst_g


# ---- generate over dense caches, and the legacy engine ---------------------

GEN_KERNELS = ("rms_norm", "swiglu")


def _generate(model, ids, n_new, **kw):
    """``model.generate`` with the JAX bench's arguments (greedy unless
    ``kw`` says otherwise, no eos, pad 0), waited on; returns (ids,
    scores, seconds)."""
    import torch
    kw = {**dict(decode_strategy="greedy_search", eos_token_id=None,
                 pad_token_id=0), **kw}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, scores = model.generate(ids, max_new_tokens=n_new, **kw)
    torch.cuda.synchronize()
    return out, scores, time.perf_counter() - t0


def _gen_launch_check(tag, launches, forwards, cfg, moe=False):
    """A dense-cache forward launches 2L + 1 RMSNorms and L SwiGLUs (the
    shared expert's, in a MoE layer) and, dropless, 3L grouped matmuls;
    its attention is plain PyTorch (``sdpa_with_cache``), so no K12."""
    L = cfg.num_hidden_layers
    want = {n: 0 for n in launches}
    want.update({"rms_norm": (2 * L + 1) * forwards,
                 "swiglu": L * forwards})
    if moe:
        want["grouped_matmul"] = 3 * L * forwards
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want} for "
                             f"{forwards} forwards")


def phase_decode_bench(model, batch=8, prompt=128, n_new=128, dev="cuda"):
    """bench.py:_decode_bench on the port: Llama-1B (4 layers, bf16,
    seeded random weights), batch 8, prompts of 128 tokens, 128 new (the
    bench's 512, cut for the script's time limit), greedy, no eos. Per
    token: the long run's time minus a 4-token run's over the tokens
    between them (the minimum of two runs each, on
    distinct prompts; both lengths warmed up first). Launches are counted
    over the four timed runs; then one run under sync debug mode 'error'
    holds the eos-less loop to no host synchronisation."""
    import torch
    cfg = model.config
    L = cfg.num_hidden_layers
    base = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (batch, prompt))
    ids = torch.tensor(base, device=dev)
    prompts = [torch.tensor(np.roll(base, i + 1, axis=1), device=dev)
               for i in range(6)]
    _generate(model, ids, n_new)
    _generate(model, prompts[0], 4)
    torch.cuda.reset_peak_memory_stats()
    wrappers = _counted(GEN_KERNELS)
    long_s = min(_generate(model, prompts[i], n_new)[2] for i in (1, 2))
    short_s = min(_generate(model, prompts[i], 4)[2] for i in (3, 4))
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = 2 * n_new + 2 * 4
    _gen_launch_check("generate", launches, forwards, cfg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_tok = max(long_s - short_s, 1e-9) / (n_new - 4)
    log(f"[generate] decode bench (bench.py:_decode_bench, Llama-1B bf16, "
        f"batch {batch}, prompt {prompt}): {n_new} new in {long_s:.3f} s, "
        f"4 new in {short_s:.3f} s: {per_tok * 1e3:.2f} ms/token/batch, "
        f"{batch / per_tok:.1f} tokens/s; peak memory {peak:.2f} GB")
    log(f"[generate] launches over the 4 timed runs ({forwards} forwards): "
        f"{launches}; per token {2 * L + 1} rms_norm, {L} swiglu")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, scores = model.generate(ids, max_new_tokens=32,
                                     decode_strategy="greedy_search")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if tuple(out.shape) != (batch, 32) or not torch.isfinite(scores).all():
        raise AssertionError(f"[generate] sync-debug run gave "
                             f"{tuple(out.shape)}, scores {scores}")
    log(f"[generate] 32 new tokens under torch.cuda.set_sync_debug_mode"
        f"('error'): the eos-less loop made no host synchronisation")
    return dict(launches=launches, ms_per_token=per_tok * 1e3,
                tok_s=batch / per_tok, peak_gb=peak)


def phase_generate_8b(model, batch=8, prompt=128, n_new=64, dev="cuda"):
    """``generate`` on serve's Llama-3-8B (bf16): batch 8,
    prompts of 128 tokens, 64 new: greedy (launches counted), then
    sampling as examples/serve_llama.py samples (top_p 0.9, temperature
    0.8, seed 7) twice, which must give the same ids; then the first
    prompt alone, greedy, and with an eos from its stream, which must
    stop there with the greedy prefix (one host synchronisation a
    token)."""
    import torch
    cfg = model.config
    ids = torch.tensor(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (batch, prompt)), device=dev)
    _generate(model, ids, 4)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    wrappers = _counted(GEN_KERNELS)
    greedy, scores, wall = _generate(model, ids, n_new)
    launches = {k: w.launches for k, w in wrappers.items()}
    _gen_launch_check("generate 8b", launches, n_new, cfg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not torch.isfinite(scores).all():
        raise AssertionError(f"[generate 8b] scores {scores}")
    log(f"[generate 8b] Llama-3-8B bf16 greedy, batch {batch}, prompt "
        f"{prompt}, {n_new} new in {wall:.3f} s (prefill included): "
        f"{batch * n_new / wall:.1f} tokens/s, peak memory {peak:.2f} GB; "
        f"scores {[round(float(s), 3) for s in scores]}")
    sample = dict(decode_strategy="sampling", top_p=0.9, temperature=0.8,
                  seed=7)
    a, sa, wall_s = _generate(model, ids, n_new, **sample)
    b, _, _ = _generate(model, ids, n_new, **sample)
    if not torch.equal(a, b):
        raise AssertionError("[generate 8b] two sampling runs with seed 7 "
                             "gave different ids")
    log(f"[generate 8b] sampling (top_p 0.9, temperature 0.8, seed 7) in "
        f"{wall_s:.3f} s: {batch * n_new / wall_s:.1f} tokens/s; a second "
        f"run with the seed gave the same ids; {int((a == greedy).sum())}"
        f"/{a.numel()} tokens equal greedy's")
    # the first prompt alone, greedy without and with an eos: the first
    # token of the second half of its stream that it has not emitted
    # before (else its last new one). Batch 1, not row 0 of batch 8:
    # cuBLAS rounds another M otherwise, and bf16 near ties flip.
    one, _, wall_1 = _generate(model, ids[:1], n_new)
    row = one[0].tolist()
    new = [i for i in range(n_new) if row[i] not in row[:i]]
    j = next((i for i in new if i >= n_new // 2), new[-1])
    out, _, wall_e = _generate(model, ids[:1], n_new, eos_token_id=row[j])
    if out[0].tolist() != row[:j + 1]:
        raise AssertionError(f"[generate 8b] eos run gave {out[0].tolist()}"
                             f", not the greedy prefix {row[:j + 1]}")
    log(f"[generate 8b] batch 1: {n_new} new in {wall_1:.3f} s without an "
        f"eos ({wall_1 / n_new * 1e3:.2f} ms a token, prefill included); "
        f"eos = its token {j}: stopped after {j + 1} tokens in "
        f"{wall_e:.3f} s ({wall_e / (j + 1) * 1e3:.2f} ms a token, one "
        f"poll of the device a token); {int((one[0] == greedy[0]).sum())}"
        f"/{n_new} tokens equal batch 8's row 0")
    return dict(launches=launches, tok_s=batch * n_new / wall, peak_gb=peak)


def generate_moe(model, batch=4, prompt=64, n_new=16, dev="cuda"):
    """``generate`` on serve_moe's qwen2_moe_a14b (28 layers, dropless,
    bf16): batch 4, prompts of 64 tokens, 16 new, greedy; each forward
    routes B * S rows through K14."""
    import torch
    cfg = model.config
    ids = torch.tensor(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (batch, prompt)), device=dev)
    _generate(model, ids, 2)                     # warm-up
    wrappers = _counted(GEN_KERNELS + MOE_KERNELS)
    out, scores, wall = _generate(model, ids, n_new)
    launches = {k: w.launches for k, w in wrappers.items()}
    _gen_launch_check("generate moe", launches, n_new, cfg, moe=True)
    if tuple(out.shape) != (batch, n_new) or not torch.isfinite(
            scores).all():
        raise AssertionError(f"[generate moe] {tuple(out.shape)} {scores}")
    log(f"[generate moe] qwen2_moe_a14b greedy, batch {batch}, prompt "
        f"{prompt}, {n_new} new in {wall:.3f} s (prefill included): "
        f"{batch * n_new / wall:.1f} tokens/s; launches {launches} "
        f"(a decode forward routes {batch * cfg.num_experts_per_tok} rows "
        f"through 3 grouped matmuls a layer)")
    return dict(launches=launches, tok_s=batch * n_new / wall)


def phase_legacy(cfg, model, serve, dev="cuda"):
    """The legacy engine (``unified=False``: prefill waves and adaptive
    decode chunks) on serve's model, geometry and traffic: 12 requests
    through the pipelined ``run()`` (launches counted), then the same
    through serial ``step()`` turns, whose greedy streams must equal
    run()'s; tok/s against serve's unified engine (telemetry, as the JAX
    bench's A/B), the counters, and the greedy agreement with serve's
    streams (reported: K12 takes another warp layout at the legacy
    engine's [S, 1] decode forwards than at the unified step's [S, C]
    one). Then 4 requests over int8 pools (K13)."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    L = cfg.num_hidden_layers

    def make(**kw):
        return ContinuousBatchingEngine(
            model, num_slots=8, page_size=16, max_len=2048,
            prefill_chunk=256, decode_chunk=8, prefix_cache=False,
            audit=True, unified=False, device=dev, **kw)

    eng = make()
    warm, prompts = _serve_traffic(cfg.vocab_size)
    eng.add_request(warm, 4)
    eng.run()
    eng.reset_gauges()
    n_new = 32
    ids = [eng.add_request(p, n_new) for p in prompts]
    attn = "ragged_paged_attention"
    wrappers = _counted(("rms_norm", "swiglu", attn))
    fw0 = eng._stats["forwards"]
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = eng._stats["forwards"] - fw0
    _launch_check("legacy", launches, forwards, L)
    _drain_check("legacy", eng)
    by = {r.request_id: r.tokens for r in done}
    streams = [by[i] for i in ids]
    if any(len(s) != n_new for s in streams):
        raise AssertionError(f"[legacy] {[len(s) for s in streams]} tokens")
    g = eng.gauges()
    tok_s = 12 * n_new / wall
    log(f"[legacy] 12 requests ({n_new} new each) in {wall:.2f} s through "
        f"run(): {tok_s:.1f} generated tok/s (unified {serve['tok_s']:.1f}:"
        f" unified/legacy x{serve['tok_s'] / tok_s:.2f}); compiled_programs"
        f" {g['compiled_programs']} {sorted(eng._compiled)}, prefill_waves "
        f"{g['prefill_waves']}, chunks {g['chunks_dispatched']}, "
        f"chunks_empty {g['chunks_empty']}, {forwards} forwards, "
        f"prefill_overlap_frac {g['prefill_overlap_frac']:.3f}")
    log(f"[legacy] launches {launches} (per forward: {2 * L + 1} rms_norm, "
        f"{L} swiglu, {L} attention)")
    same = sum(a == b for a, b in zip(streams, serve["streams"]))
    log(f"[legacy] greedy agreement with serve's unified streams: "
        f"{_agreement(streams, serve['streams']):.4f} ({same}/12 streams "
        f"identical; first divergences (stream, token): "
        f"{_first_diff(streams, serve['streams'])})")
    eng.reset_gauges()
    ids = [eng.add_request(p, n_new) for p in prompts]
    t0 = time.perf_counter()
    done = _serial(eng)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by = {r.request_id: r.tokens for r in done}
    if [by[i] for i in ids] != streams:
        raise AssertionError(
            f"[legacy] serial step() streams differ from run()'s at "
            f"{_first_diff([by[i] for i in ids], streams)}")
    g = eng.gauges()
    log(f"[legacy] the same 12 requests through serial step(): "
        f"{wall_s:.2f} s, {12 * n_new / wall_s:.1f} generated tok/s, "
        f"prefill_waves {g['prefill_waves']}, chunks "
        f"{g['chunks_dispatched']}; greedy streams identical to run()'s")
    _drain_check("legacy", eng)
    del eng
    torch.cuda.empty_cache()
    # int8 pools: the first 4 requests, 16 new
    eng = make(kv_quant="int8")
    eng.add_request(warm, 4)
    eng.run()
    quant = "ragged_paged_attention_quant"
    wrappers = _counted(("rms_norm", "swiglu", attn, quant))
    fw0 = eng._stats["forwards"]
    ids = [eng.add_request(p, 16) for p in prompts[:4]]
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_q = time.perf_counter() - t0
    launches_q = {k: w.launches for k, w in wrappers.items()}
    forwards_q = eng._stats["forwards"] - fw0
    _launch_check("legacy int8", launches_q, forwards_q, L, attn=quant)
    _drain_check("legacy int8", eng)
    by = {r.request_id: r.tokens for r in done}
    q_streams = [by[i] for i in ids]
    log(f"[legacy int8] 4 requests x 16 new over int8 pools in "
        f"{wall_q:.2f} s, {forwards_q} forwards, launches {launches_q}; "
        f"greedy agreement with the bf16 legacy streams "
        f"{_agreement(q_streams, [s[:16] for s in streams[:4]]):.4f}")
    del eng
    torch.cuda.empty_cache()
    total = {k: launches.get(k, 0) + launches_q.get(k, 0)
             for k in set(launches) | set(launches_q)}
    return dict(launches=total, tok_s=tok_s, streams=streams)


# ---- the model families: GPT-2, ERNIE, DeepSeek-V2 and Llama-3-70B --------

#: K12's mixed batch as the serve phase gives it: (chunk, lengths, ctx)
#: of 8 slots (idle, decode and prefill) over pages of 16, max_len 2048
SERVE_MIXED = (256, (0, 1, 1, 17, 256, 256, 1, 100),
               (0, 1800, 700, 300, 0, 1000, 1200, 33))
#: ... and as the fleet's and the HTTP phase's engines give it (prefill
#: chunk 32, pages of 32, max_len 384)
FLEET_MIXED = (32, (0, 1, 1, 32, 32, 1, 17, 32),
               (0, 350, 200, 0, 96, 60, 300, 320))


def _ragged_at(tag, nh, kvh, d, dev, seed, log_tag="model_kernels",
               page=16, max_len=2048, mixed=SERVE_MIXED):
    """K12 at one head layout against its plain version per element
    (``ragged_checks``; bf16 and f32), on a mixed batch (``mixed``: the
    serve phase's idle, decode and prefill slots in a chunk of 256 by
    default; the NaN trash page) and at a decode step (one token in each
    of 8 slots, contexts 64 to ``max_len``, its split plan), a second
    launch repeating the bits; each timed beside its bound. Returns
    {"mixed": ..., "decode": ...}."""
    import torch
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    B, mp = 8, max_len // page
    P = B * mp + 1
    kp, vp = rand(kvh, P, page, d), rand(kvh, P, page, d)
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    ones = np.ones(B, np.int32)
    ctx1 = np.linspace(64, mp * page, B).astype(np.int32) - 1
    C, lengths, ctx = mixed
    layouts = {"mixed": (C, np.array(lengths, np.int32),
                         np.array(ctx, np.int32)),
               "decode": (1, ones, ctx1)}
    res = {}
    for name, (C, lengths, ctx) in layouts.items():
        tables = _mixed_tables(B, P, mp, page, ctx, lengths, seed + C)
        args = (rand(B, C, nh, d), kp, vp,
                *(torch.from_numpy(a).to(dev) for a in (tables, ctx,
                                                         lengths)))
        out = krpa.ragged_paged_attention(*args)
        ref = krpa.ragged_paged_attention_reference(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or any(
                out[b, lengths[b]:].any() for b in range(B)):
            raise AssertionError(f"ragged attention {tag} {name}: "
                                 f"non-finite output or rows past a slot's "
                                 f"length not zero")
        err, worst, worst1, err32, worst32 = ragged_checks(krpa, args, ref,
                                                           out)
        if not torch.equal(krpa.ragged_paged_attention(*args), out):
            raise AssertionError(f"ragged attention {tag} {name}: a second "
                                 f"launch gave other bits")
        ms = time_ms(krpa.ragged_paged_attention, args)
        plain = time_ms(krpa.ragged_paged_attention_reference, args,
                        iters=2)
        kv_keys = int(np.sum((ctx + lengths)[lengths > 0]))
        n_bytes = (int(lengths.sum()) * nh * d * 2 + B * C * nh * d * 2
                   + 2 * kv_keys * kvh * d * 2)
        pairs = sum(int(ctx[b]) * int(lengths[b])
                    + int(lengths[b]) * (int(lengths[b]) + 1) // 2
                    for b in range(B))
        b_ms, b_by = bound(n_bytes, 4 * d * nh * pairs, PEAK_BF16)
        plan = krpa.split_plan(B, C, kvh, nh // kvh, d, mp * page)
        shape = (f"q[{B},{C},{nh},{d}] pools[{kvh},{P},{page},{d}] bf16 "
                 f"(rep {nh // kvh}) {name}")
        log(f"[{log_tag}] ragged_paged_attention {tag} at {shape}, lengths "
            f"{lengths.tolist()} ctx {ctx.tolist()}: bf16 max abs err "
            f"{err:.3g} (worst err/limit {worst:.3g}; vs f32 plain "
            f"{worst1:.3g}); f32 {err32:.3g} (worst {worst32:.3g}); a "
            f"second launch repeats it bit for bit; split plan {plan}; "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms bound {b_ms:.4f} ms "
            f"({b_by})")
        res[name] = dict(max_abs_err=err, max_abs_err_f32=err32, ms=ms,
                         plain_ms=plain, library_ms=None, bound_ms=b_ms,
                         bound_by=b_by, shape=shape, split_plan=str(plan))
        del args, out, ref
    del kp, vp
    torch.cuda.empty_cache()
    return res


def phase_model_kernels(dev="cuda"):
    """The kernels at the shapes the new model paths give them, each
    against its plain version per element, bits repeated, timed beside
    its bound: K7-K9 at ERNIE's [16, 512] non-causal and GPT-2's [8,
    1024] causal (12 heads, D 64); K12 at GPT-2's 12/12 heads (rep 1, D
    64) and Llama-3-70B's 64/8 (rep 8, D 128), each in a mixed and a
    decode step; K1/K2 at DeepSeek's latent widths 512 and 1536 and its
    hidden 5120, K5/K6 at its widths 1536, 3072 and 12288 ([2, 2048]
    tokens); K14, K14-T and K15 at DeepSeek's training layout (160
    experts, top-6 of 4096 tokens, d 5120, h 1536) and K14 both modes at
    its decode layout (8 tokens); K1 at [256, 2048], K5 at [256, 5632]
    and K12 (16/8 heads, pages of 32, a mixed chunk of 32 and a decode
    step) as the fleet's and the HTTP phase's Llama-1B engines run them.
    Returns {kernel: {tag: entry}}."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig
    gen = torch.Generator(device=dev).manual_seed(2024)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)
    out = {}

    def put(tag, entries):
        for name, entry in entries.items():
            out.setdefault(name, {})[tag] = entry
    put("ernie", flash_checks(16, 512, 12, 12, 64, rand, causal=False))
    put("gpt2", flash_checks(8, 1024, 12, 12, 64, rand))
    for tag, nh, kvh, d in (("gpt2", 12, 12, 64), ("llama70", 64, 8, 128)):
        for layout, entry in _ragged_at(tag, nh, kvh, d, dev,
                                        seed=31 + nh).items():
            out.setdefault("ragged_paged_attention", {})[
                f"{tag}_{layout}"] = entry
    for D in (512, 1536, 5120):
        put(f"deepseek_D{D}", norm_checks(4096, D, 1e-6, rand,
                                          tag="model_kernels"))
    for I in (1536, 3072, 12288):
        put(f"deepseek_I{I}", swiglu_checks(4096, I, rand,
                                            tag="model_kernels"))
    # the fleet's and the HTTP phase's Llama-1B engines: 8 slots x chunk
    # 32 = 256 rows a mixed forward, 16/8 heads, pages of 32, max_len 384
    cfg1b = LlamaConfig.llama_1b()
    put("fleet", norm_checks(256, cfg1b.hidden_size, cfg1b.rms_norm_eps,
                             rand, kernels=("rms_norm",),
                             tag="model_kernels fleet"))
    put("fleet", swiglu_checks(256, cfg1b.intermediate_size, rand,
                               kernels=("swiglu",),
                               tag="model_kernels fleet"))
    for layout, entry in _ragged_at(
            "fleet", cfg1b.num_attention_heads, cfg1b.num_key_value_heads,
            cfg1b.head_dim, dev, seed=44, page=32, max_len=384,
            mixed=FLEET_MIXED).items():
        out.setdefault("ragged_paged_attention", {})[
            f"fleet_{layout}"] = entry
    errs, entries = _grouped_at("deepseek", 160, 6, 5120, 1536,
                                (torch.bfloat16,), 4096, dev,
                                log_tag="model_kernels")
    put("deepseek", {name: dict(entry, max_abs_err=errs[name][0])
                     for name, entry in entries.items()})
    put("deepseek_decode", _grouped_decode(top_k=6, n_experts=160, d=5120,
                                           h=1536, tag="model_kernels"))
    return out


GPT2_KERNELS = ("flash_attention_fwd", "flash_attention_dkv",
                "flash_attention_dq", "ragged_paged_attention",
                "ragged_paged_attention_quant")


def phase_gpt2(dev="cuda"):
    """GPT-2 small (124M: 12 layers, 768 wide, 12 heads, vocab 50257),
    seeded random weights: (a) examples/train_gpt2.py's flow in f32 with
    dropout 0.1 (BASELINE config 1): AdamW, decay 0.01, under
    LinearWarmup(3e-4, 20 steps from 0) with ClipGradByGlobalNorm(1.0),
    40 steps of [8, 1024] windows of the Markov corpus (the mean of the
    last 5 losses must be 0.15 below the first 5's), then a save, a load
    into a fresh model and optimizer and one resumed step that must equal
    the original's bit for bit; live dropout takes the plain attention,
    so no kernel runs; (b) one bf16 step at dropout 0 (K7-K9, counted
    exactly); (c) ``generate``, batch 8, prompts of 128, 64 new, greedy;
    (d) the engine, 8 slots, page 16: 12 requests (prompts 64-900, 32
    new) through run() (K12 counted), their agreement with ``generate``'s
    streams reported; 4 requests over int8 pools (K13), one under
    weight-only int8."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, lr
    cfg = GPT2Config.small()
    L, batch, seq = cfg.num_hidden_layers, 8, 1024
    corpus = synthetic_corpus(512, batch * seq * 50)

    def sample_batch(step):
        rng = np.random.RandomState(step)
        idx = rng.randint(0, corpus.size - seq, batch)
        return torch.from_numpy(np.stack(
            [corpus[i:i + seq] for i in idx])).to(dev)

    def build(seed):
        model = GPT2ForCausalLM(cfg, device=dev, seed=seed, dropout_seed=1)
        sched = lr.LinearWarmup(3e-4, warmup_steps=20, start_lr=0.0,
                                end_lr=3e-4)
        opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                    weight_decay=0.01,
                    grad_clip=pnn.ClipGradByGlobalNorm(1.0))
        return model, opt, sched

    def train_step(model, opt, sched, ids):
        _, loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.item()

    # (a) the train_gpt2 flow, f32, dropout 0.1
    model, opt, sched = build(0)
    n_params = sum(p.numel() for p in model.parameters())
    wrappers = _counted(GPT2_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for step in range(40):
        t0 = time.perf_counter()
        losses.append(train_step(model, opt, sched, sample_batch(step)))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches_a = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first - 0.15:
        raise AssertionError(f"[gpt2] (a) the loss did not drop: {first:.4f}"
                             f" -> {last:.4f}: {losses}")
    if any(launches_a.values()):
        raise AssertionError(f"[gpt2] (a) live dropout takes the plain "
                             f"attention, yet kernels ran: {launches_a}")
    t = Timing(walls[2:])
    log(f"[gpt2] (a) GPT-2 small {n_params / 1e6:.1f} M params f32, dropout "
        f"0.1, AdamW(LinearWarmup(3e-4, 20), decay 0.01, "
        f"ClipGradByGlobalNorm(1.0)), 40 steps of [{batch}, {seq}]: step "
        f"{t:.1f} ms (median [least-greatest] of steps 2-39), "
        f"{batch * seq / (t / 1e3):.0f} tokens/s, peak memory {peak:.2f} "
        f"GB; loss {first:.4f} (first 5) -> {last:.4f} (last 5); "
        f"launches {launches_a} (live dropout: the plain attention)")
    tmp = tempfile.mkdtemp(prefix="gpt2_")
    try:
        ptt.save(model.state_dict(), os.path.join(tmp, "model.pdparams"))
        ptt.save(opt.state_dict(), os.path.join(tmp, "opt.pdopt"))
        model2, opt2, sched2 = build(1)
        model2.load_state_dict(ptt.load(os.path.join(tmp, "model.pdparams"),
                                        device=dev))
        opt2.set_state_dict(ptt.load(os.path.join(tmp, "opt.pdopt"),
                                     device=dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # both continue from the same state: the same dropout draws too
    model2.dropout_generator.set_state(model.dropout_generator.get_state())
    ids = sample_batch(0)
    resumed = [train_step(m, o, s, ids)
               for m, o, s in ((model, opt, sched), (model2, opt2, sched2))]
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 model2.parameters()))
    if resumed[0] != resumed[1] or not same or opt.get_lr() != opt2.get_lr():
        raise AssertionError(f"[gpt2] (a) the resumed step differs: losses "
                             f"{resumed}, weights equal {same}")
    log(f"[gpt2] (a) saved, loaded into a fresh model and optimizer: the "
        f"resumed step's loss {resumed[1]:.6f} and weights equal the "
        f"original's bit for bit")
    del model, opt, model2, opt2
    torch.cuda.empty_cache()

    # (b) one bf16 step at dropout 0: flash attention
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_dropout_prob=0.0)
    model = GPT2ForCausalLM(cfg0, device=dev, dtype=torch.bfloat16, seed=0)
    ids = sample_batch(1)
    model(ids, labels=ids)[1].backward()
    model.zero_grad(set_to_none=True)
    wrappers = _counted(GPT2_KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = model(ids, labels=ids)
    loss.backward()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches_b = {k: w.launches for k, w in wrappers.items()}
    want = {n: 0 for n in GPT2_KERNELS}
    want.update(flash_attention_fwd=L, flash_attention_dkv=L,
                flash_attention_dq=L)
    if launches_b != want or not np.isfinite(loss.item()):
        raise AssertionError(f"[gpt2] (b) launches {launches_b} != {want} "
                             f"or loss {loss.item()}")
    log(f"[gpt2] (b) bf16, dropout 0, [{batch}, {seq}]: loss "
        f"{loss.item():.4f}, forward+backward {step_ms:.1f} ms (one step, "
        f"host clock), launches {launches_b}")
    del model, loss
    model = GPT2ForCausalLM(cfg0, device=dev, dtype=torch.bfloat16,
                            seed=0).eval()

    # (c) generate
    prompts = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (8, 128))).to(dev)
    _generate(model, prompts, 4)
    out, _, secs = _generate(model, prompts, 64)
    log(f"[gpt2] (c) generate batch 8, prompt 128, 64 new, greedy: "
        f"{secs * 1e3 / 64:.2f} ms a token ({8 * 64 / secs:.0f} tokens/s; "
        f"no kernel on this path: LayerNorm, GELU and the dense-cache "
        f"attention are plain)")

    # (d) the engine
    rng = np.random.RandomState(42)
    reqs = [rng.randint(0, cfg.vocab_size, int(n)) for n in
            rng.permutation(np.linspace(64, 900, 12).astype(int))]
    n_new = 32

    def serve(m, reqs, **kw):
        eng = ContinuousBatchingEngine(m, num_slots=8, page_size=16,
                                       max_len=1024, prefill_chunk=256,
                                       decode_chunk=8, prefix_cache=False,
                                       device=dev, **kw)
        eng.add_request(reqs[0][:16], 4)
        eng.run()
        fw0 = eng._stats["forwards"]
        w = _counted(GPT2_KERNELS)
        for p in reqs:
            eng.add_request(p, n_new)
        t0 = time.perf_counter()
        done = sorted(eng.run(), key=lambda r: r.request_id)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(done) != len(reqs) or any(len(r.tokens) != n_new
                                         for r in done):
            raise AssertionError(f"[gpt2] {len(done)} of {len(reqs)} "
                                 f"requests completed")
        if len(eng._free_pages) != eng.num_pages - 1:
            raise AssertionError("[gpt2] pages were not all returned")
        return ([r.tokens for r in done], {k: v.launches for k, v in
                                           w.items()},
                eng._stats["forwards"] - fw0, wall)

    launches_d = {n: 0 for n in GPT2_KERNELS}
    streams, got, forwards, wall = serve(model, reqs)
    _launch_only("gpt2 serve", got, forwards, L, "ragged_paged_attention")
    _add(launches_d, got)
    gen_streams = [_generate(model, torch.from_numpy(p[None]).to(dev),
                             n_new)[0][0].tolist() for p in reqs]
    log(f"[gpt2] (d) engine, 8 slots, page 16, 12 requests (prompts "
        f"{sorted(len(p) for p in reqs)}), {n_new} new: "
        f"{12 * n_new / wall:.1f} generated tok/s, {forwards} forwards; "
        f"bf16 agreement with "
        f"generate's streams {_agreement(streams, gen_streams):.4f} "
        f"({sum(a == b for a, b in zip(streams, gen_streams))}/12 "
        f"identical; K12's layouts part them at near ties, f32 holds them "
        f"equal in model_parity)")
    s8, got, forwards, wall = serve(model, reqs[:4], kv_quant="int8")
    _launch_only("gpt2 int8", got, forwards, L,
                 "ragged_paged_attention_quant")
    _add(launches_d, got)
    log(f"[gpt2] (d) 4 requests over int8 pools: {4 * n_new / wall:.1f} "
        f"tok/s, agreement with the bf16 pools' streams "
        f"{_agreement(s8, streams[:4]):.4f}")
    del model
    torch.cuda.empty_cache()
    wq = GPT2ForCausalLM(dataclasses.replace(
        cfg0, weight_quant="weight_only_int8"), device=dev,
        dtype=torch.bfloat16, seed=0).eval()
    sq, got, forwards, wall = serve(wq, reqs[:1])
    _launch_only("gpt2 weight_only_int8", got, forwards, L,
                 "ragged_paged_attention")
    _add(launches_d, got)
    n_wol = sum(isinstance(m, pnn.quant.WeightOnlyLinear)
                for m in wq.modules())
    log(f"[gpt2] (d) 1 request under weight_only_int8 ({n_wol} layers "
        f"converted): agreement with bf16 "
        f"{_agreement(sq, streams[:1]):.4f}")
    del wq
    torch.cuda.empty_cache()
    return dict(launches=_add(launches_b, launches_d), step_ms_f32=t,
                losses=losses)


def _add(into, more):
    """Add launch counts into ``into`` (returned)."""
    for k, v in more.items():
        into[k] = into.get(k, 0) + v
    return into


def _launch_only(tag, launches, forwards, n_layers, attn):
    """A serving forward of a model whose only kernel is its attention
    (GPT-2: LayerNorm and GELU are plain) launches ``attn`` once a layer."""
    want = {n: 0 for n in launches}
    want[attn] = n_layers * forwards
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want} for "
                             f"{forwards} forwards")


def phase_ernie(dev="cuda"):
    """ERNIE-3.0-base (12 layers, 768 wide, 12 heads, vocab 40000) in bf16,
    seeded random weights, dropout 0: ErnieForPretraining on [16, 512]
    with 15% of the positions masked and SOP labels, 10 AdamW steps (the
    loss must fall; K7-K9 non-causal, counted exactly); a padded batch
    with ``attention_mask`` (the plain path) whose outputs at the valid
    positions must equal each row's unpadded run, in bf16 and in f32,
    where the same batch without its mask must be refused; one step of
    ErnieForSequenceClassification."""
    import dataclasses

    import torch
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                         ErnieForSequenceClassification)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dataclasses.replace(ErnieConfig.base(), hidden_dropout_prob=0.0,
                              attention_dropout_prob=0.0)
    L, B, S = cfg.num_hidden_layers, 16, 512
    model = ErnieForPretraining(cfg, device=dev, dtype=torch.bfloat16,
                                seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(3)
    ids = rng.randint(5, cfg.vocab_size, (B, S))
    labels = np.full((B, S), -100)
    masked = rng.rand(B, S) < 0.15
    masked[:, 0] = False
    labels[masked] = ids[masked]
    ids[masked] = 3
    sop = rng.randint(0, 2, B)
    ids, labels, sop = (torch.from_numpy(a).to(dev) for a in (ids, labels,
                                                              sop))
    opt = AdamW(1e-4, parameters=model.parameters())
    wrappers = _counted(GPT2_KERNELS[:3])
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        loss = model(ids, masked_lm_labels=labels, sop_labels=sop)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 10 * L for n in GPT2_KERNELS[:3]}
    if launches != want:
        raise AssertionError(f"[ernie] launches {launches} != {want}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[ernie] the loss did not fall: {losses}")
    t = Timing(walls[1:])
    log(f"[ernie] ERNIE-3.0-base {n_params / 1e6:.1f} M params bf16, "
        f"pretraining (MLM 15% + SOP) on [{B}, {S}], 10 AdamW steps: step "
        f"{t:.1f} ms (median [least-greatest] of steps 1-9), "
        f"{B * S / (t / 1e3):.0f} tokens/s, peak memory {peak:.2f} GB; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches} "
        f"(non-causal flash, 12 heads, D 64)")
    del opt
    # the padded batch: the plain path with the mask, against each row's
    # own unpadded run (flash, no mask), in bf16 and then in f32. In f32
    # the two differ by summation order only, and the same batch run
    # without its mask (its rows attending to their padding) must be
    # refused. At these random weights an ignored mask moves the outputs
    # by about twice bf16's rounding noise, so the bf16 limit cannot
    # refuse it: that reading is logged, and the f32 gate decides the mask
    model.eval()
    lens = [512, 300, 129, 40]
    pad = torch.zeros(4, S, dtype=torch.long, device=dev)
    mask = torch.zeros(4, S, dtype=torch.long, device=dev)
    for i, n in enumerate(lens):
        pad[i, :n] = ids[i, :n]
        mask[i, :n] = 1
    readings = {}
    limits = {torch.bfloat16: (ERNIE_PAD_ULPS * BF16_ULP, ERNIE_PAD_ATOL),
              torch.float32: ERNIE_PAD_F32}
    for dtype, (rel, atol) in limits.items():
        model.to(dtype)
        with torch.no_grad():
            ones = [model.ernie(ids[i:i + 1, :n])[0][0].float()
                    for i, n in enumerate(lens)]

            def worst_ratio(seq_pad):
                return max(((seq_pad[i, :n].float() - one).abs()
                            / (rel * one.abs() + atol)).max().item()
                           for i, (n, one) in enumerate(zip(lens, ones)))
            readings[dtype] = (
                worst_ratio(model.ernie(pad, attention_mask=mask)[0]),
                worst_ratio(model.ernie(pad)[0]))
    (worst, unmasked16), (worst32, unmasked) = readings.values()
    if max(worst, worst32) > 1.0:
        raise AssertionError(f"[ernie] padded rows part from their unpadded "
                             f"runs: worst err/limit {worst:.3g} (bf16), "
                             f"{worst32:.3g} (f32)")
    if unmasked <= 1.0:
        raise AssertionError(f"[ernie] the f32 padded-batch limit does not "
                             f"refuse a batch run without its mask: worst "
                             f"err/limit {unmasked:.3g}")
    log(f"[ernie] padded batch (lengths {lens}, attention_mask: the plain "
        f"path) against each row's unpadded run (flash): bf16 worst "
        f"err/limit {worst:.3g} (limit {ERNIE_PAD_ULPS} bf16 ulps of |ref| "
        f"+ {ERNIE_PAD_ATOL}; without the mask {unmasked16:.3g}, which this "
        f"limit cannot refuse), f32 worst err/limit {worst32:.3g} (limit "
        f"{ERNIE_PAD_F32[0]:g} of |ref| + {ERNIE_PAD_F32[1]:g}; without the "
        f"mask {unmasked:.4g}, refused)")
    del model, ones
    torch.cuda.empty_cache()
    cls = ErnieForSequenceClassification(cfg, num_classes=3, device=dev,
                                         dtype=torch.bfloat16, seed=1)
    opt = AdamW(1e-4, parameters=cls.parameters())
    y = torch.from_numpy(rng.randint(0, 3, B)).to(dev)
    w = _counted(GPT2_KERNELS[:3])
    loss = cls(ids, labels=y)
    loss.backward()
    grads_ok = all(torch.isfinite(p.grad).all() for p in cls.parameters()
                   if p.grad is not None)
    opt.step()
    got = {k: v.launches for k, v in w.items()}
    if not (grads_ok and np.isfinite(loss.item())) or got != {
            n: L for n in GPT2_KERNELS[:3]}:
        raise AssertionError(f"[ernie] classification step: loss "
                             f"{loss.item()}, finite grads {grads_ok}, "
                             f"launches {got}")
    log(f"[ernie] ErnieForSequenceClassification, 3 classes, [{B}, {S}]: "
        f"one AdamW step, loss {loss.item():.4f}, launches {got}")
    del cls, opt
    torch.cuda.empty_cache()
    return dict(launches=_add(launches, got), step_ms=t, losses=losses)


#: padded vs unpadded ERNIE rows in bf16: the masked plain attention and
#: flash round their probabilities at other points and the shorter rows'
#: matmuls sum in other orders; 12 post-norm layers carry that as a few
#: ulps of each unit-scale output, with an absolute floor for the
#: entries near 0
#: the MLA decode bench's new tokens: the bench's 256 cut for the
#: script's time limit
DS_DECODE_NEW = 128
ERNIE_PAD_ULPS = 16
ERNIE_PAD_ATOL = 0.05
#: the same in f32 (relative, absolute): the two paths sum in other
#: orders, a few f32 ulps that 12 layers carry to about 4e-6 at most; an
#: ignored mask moves the outputs by 2e-2 to 4e-2
ERNIE_PAD_F32 = (1e-5, 1e-4)


def deepseek_config(layers, **kw):
    """DeepseekV2Config()'s full width (H 5120, 128 heads, q_lora 1536,
    kv_lora 512, 160 routed experts top-6, 2 shared, vocab 102400) at
    depth ``layers`` (the first dense, the rest MoE)."""
    import dataclasses
    from paddle_tpu_torch.models import DeepseekV2Config
    return dataclasses.replace(DeepseekV2Config(), num_hidden_layers=layers,
                               **kw)


DS_KERNELS = ("rms_norm", "rms_norm_dx", "rms_norm_residual",
              "rms_norm_residual_dh", "swiglu", "swiglu_bwd") + MOE_KERNELS


def _ds_generate_want(cfg, forwards, dropless):
    """A DeepSeek cache forward: four RMSNorms a layer (input, q latent,
    kv latent, post-attention) and the final one, a SwiGLU a layer (the
    dense MLP or the shared experts), and dropless three grouped matmuls
    a MoE layer; the MLA core is plain."""
    L = cfg.num_hidden_layers
    moe = L - cfg.first_k_dense_replace
    want = {n: 0 for n in DS_KERNELS}
    want.update(rms_norm=(4 * L + 1) * forwards, swiglu=L * forwards)
    if dropless:
        want["grouped_matmul"] = 3 * moe * forwards
    return want


def _ds_moe_gates(model, dropless):
    """Switch every routed-expert layer of a built model between the
    capacity path and the dropless one (the config is read at build)."""
    for layer in model.layers:
        if layer.is_moe:
            layer.mlp.moe.gate.dropless = dropless


def phase_deepseek(dev="cuda"):
    """DeepSeek-V2 at its published width, seeded random weights, bf16:
    (a) depth 4 (1 dense, 3 MoE): ``generate`` batch 8, prompts of 128,
    64 new, greedy, on the capacity path and dropless (K14), launches
    exact, the latent cache's bytes against a per-head cache, ms a token
    and peak memory; (b) depth 2 (1 dense, 1 MoE), dropless, on [2, 2048]
    (the chunked MLA core): forward and backward of the labelled loss
    with the aux loss, grads cleared, no optimizer: step ms, peak memory,
    exact launches of K1-K6 and K14/K15; (c) bench.py:_moe_decode_bench
    on the port (its on_tpu config: H 1024, 12 layers, 16 experts, batch
    8, prompt 128, the long-minus-short protocol) at ``DS_DECODE_NEW``
    new tokens, where the bench takes 256."""
    import torch
    from paddle_tpu_torch.models import (DeepseekV2Config,
                                         DeepseekV2ForCausalLM)
    launches = {n: 0 for n in DS_KERNELS}
    # (a) depth 4, generate
    cfg = deepseek_config(4)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = DeepseekV2ForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                  seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[deepseek] DeepSeek-V2 width (H {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, q_lora {cfg.q_lora_rank}, "
        f"kv_lora {cfg.kv_lora_rank}, {cfg.n_routed_experts} experts "
        f"top-{cfg.num_experts_per_tok}, {cfg.n_shared_experts} shared) at "
        f"4 layers: {n_params / 1e9:.2f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (8, 128))).to(dev)
    per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    per_head = 2 * cfg.num_attention_heads * cfg.v_head_dim
    caches = model.init_kv_cache(8, 192)
    cache_bytes = sum(c.numel() * c.element_size() for c in caches)
    del caches
    log(f"[deepseek] (a) latent cache: {per_tok} values a token and layer "
        f"against {per_head} for per-head k/v ({per_head / per_tok:.1f}x); "
        f"batch 8 x 192 tokens x 4 layers = {cache_bytes / 1e6:.2f} MB bf16 "
        f"(per-head: {cache_bytes * per_head / per_tok / 1e6:.1f} MB)")
    gen = {}
    for dropless in (False, True):
        _ds_moe_gates(model, dropless)
        _generate(model, prompts, 2)
        w = _counted(DS_KERNELS)
        torch.cuda.reset_peak_memory_stats()
        out, _, secs = _generate(model, prompts, 64)
        got = {k: v.launches for k, v in w.items()}
        want = _ds_generate_want(cfg, 64, dropless)
        if got != want:
            raise AssertionError(f"[deepseek] (a) launches {got} != {want}")
        _add(launches, got)
        peak = torch.cuda.max_memory_allocated() / 1e9
        tag = "dropless" if dropless else "capacity"
        gen[tag] = out.tolist()
        log(f"[deepseek] (a) generate {tag}: batch 8, prompt 128, 64 new, "
            f"greedy: {secs * 1e3 / 64:.2f} ms a token "
            f"({8 * 64 / secs:.0f} tokens/s), peak memory {peak:.2f} GB, "
            f"launches {got}")
    log(f"[deepseek] (a) greedy agreement of the capacity and dropless "
        f"streams (capacity 1.25 drops tokens at prefill): "
        f"{_agreement(gen['capacity'], gen['dropless']):.4f}")
    del model, out
    torch.cuda.empty_cache()

    # (b) depth 2, training, dropless, the chunked MLA core
    cfg = deepseek_config(2, moe_dropless=True)
    model = DeepseekV2ForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                  seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 2049))
    step_ids = [torch.from_numpy(np.roll(ids, i, axis=1)).to(dev)
                for i in range(4)]

    def step(t):
        _, loss = model(t, labels=t)
        loss.backward()
        for p in model.parameters():
            p.grad = None
        return loss.item()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(step_ids[0])]
    w = _counted(DS_KERNELS)
    times = []
    for t in step_ids[1:]:
        t0 = time.perf_counter()
        losses.append(step(t))
        times.append((time.perf_counter() - t0) * 1e3)
    got = {k: v.launches for k, v in w.items()}
    per_step = {k: v / 3 for k, v in got.items()}
    want = {"rms_norm": 3 * 2 + 1, "rms_norm_dx": 3 * 2 + 1,
            "rms_norm_residual": 2, "rms_norm_residual_dh": 2,
            "swiglu": 2, "swiglu_bwd": 2, "grouped_matmul": 3,
            "grouped_matmul_t": 3, "grouped_dw": 3}
    if per_step != want or not np.all(np.isfinite(losses)):
        raise AssertionError(f"[deepseek] (b) launches per step {per_step} "
                             f"!= {want}, or losses {losses}")
    _add(launches, got)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t = Timing(times)
    log(f"[deepseek] (b) 2 layers (1 dense, 1 MoE), {n_params / 1e9:.2f} B "
        f"params bf16, dropless, [2, 2049] (the chunked MLA core, chunks "
        f"of 256), forward + backward with the aux loss: step {t:.1f} ms "
        f"(median [least-greatest] of 3), {2 * 2048 / (t / 1e3):.0f} "
        f"tokens/s, peak memory {peak:.2f} GB, losses "
        f"{[round(x, 4) for x in losses]}; launches per step {per_step}")
    prof = _profile("deepseek", lambda: step(step_ids[-1]))
    del model, step_ids
    torch.cuda.empty_cache()

    # (c) the JAX bench's MLA decode bench, its 256 new tokens cut to
    # DS_DECODE_NEW for the script's time limit
    bcfg = DeepseekV2Config(
        vocab_size=32000, hidden_size=1024, num_hidden_layers=12,
        num_attention_heads=16, q_lora_rank=384, kv_lora_rank=256,
        qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
        intermediate_size=2816, moe_intermediate_size=704,
        n_routed_experts=16, n_shared_experts=2, num_experts_per_tok=2,
        first_k_dense_replace=1, routed_scaling_factor=1.0,
        norm_topk_prob=True, max_position_embeddings=2048)
    model = DeepseekV2ForCausalLM(bcfg, device=dev, dtype=torch.bfloat16,
                                  seed=0).eval()
    base = np.random.RandomState(1).randint(0, bcfg.vocab_size, (8, 128))
    ps = [torch.from_numpy(np.roll(base, i + 1, axis=1)).to(dev)
          for i in range(5)]
    ids = torch.from_numpy(base).to(dev)
    n_new = DS_DECODE_NEW
    _generate(model, ids, n_new)
    _generate(model, ps[0], 4)
    w = _counted(DS_KERNELS)
    long_ = min(_generate(model, ps[1], n_new)[2],
                _generate(model, ps[2], n_new)[2])
    short = min(_generate(model, ps[3], 4)[2], _generate(model, ps[4], 4)[2])
    got = {k: v.launches for k, v in w.items()}
    want = _ds_generate_want(bcfg, 2 * n_new + 2 * 4, False)
    if got != want:
        raise AssertionError(f"[deepseek] (c) launches {got} != {want}")
    _add(launches, got)
    ms_tok = (long_ - short) / (n_new - 4) * 1e3
    log(f"[deepseek] (c) bench.py:_moe_decode_bench on the port (H 1024, 12 "
        f"layers, 16 experts top-2, capacity path, batch 8, prompt 128, "
        f"{n_new} new; long minus short): {ms_tok:.3f} ms/token/batch, "
        f"{8 / ms_tok * 1e3:.0f} tokens/s; launches {got}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches, train_step_ms=t, decode_ms_token=ms_tok,
                profile=prof)


def phase_llama70(dev="cuda"):
    """Llama-3-70B's width (H 8192, 64/8 heads, I 28672, vocab 128256) at
    depth 4 through the engine, bf16, seeded random weights: 4 requests
    of the serve traffic (K12 at rep 8), launches exact."""
    import dataclasses

    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = dataclasses.replace(LlamaConfig.llama3_70b(), num_hidden_layers=4,
                              scan_layers=False)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[llama70] Llama-3-70B width at 4 layers: {n_params / 1e9:.2f} B "
        f"params bf16, built in {time.perf_counter() - t0:.1f} s")
    eng = ContinuousBatchingEngine(model, num_slots=8, page_size=16,
                                   max_len=2048, prefill_chunk=256,
                                   decode_chunk=8, prefix_cache=False,
                                   device=dev)
    warm, prompts = _serve_traffic(cfg.vocab_size)
    eng.add_request(warm, 4)
    eng.run()
    fw0 = eng._stats["forwards"]
    w = _counted(SERVE_KERNELS)
    for p in prompts[:4]:
        eng.add_request(p, 32)
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v.launches for k, v in w.items()}
    forwards = eng._stats["forwards"] - fw0
    if len(done) != 4 or any(len(r.tokens) != 32 for r in done):
        raise AssertionError("[llama70] not every request completed")
    _launch_check("llama70", got, forwards, cfg.num_hidden_layers)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[llama70] 4 requests (prompts {[len(p) for p in prompts[:4]]}, "
        f"32 new) through run(): {4 * 32 / wall:.1f} generated tok/s, "
        f"{forwards} forwards, peak memory {peak:.2f} GB; launches {got} "
        f"(K12 at 64/8 heads, rep 8, D 128)")
    del eng, model
    torch.cuda.empty_cache()
    return dict(launches=got, tok_s=4 * 32 / wall)


def phase_model_parity(dev="cuda"):
    """GPT-2, ERNIE and DeepSeek-V2 at their tiny widths and depth 2, in
    f32, on the card against the CPU from the same weights: the labelled
    loss and every gradient (ERNIE: pretraining with MLM and SOP labels);
    the greedy ``generate`` stream (GPT-2, DeepSeek); GPT-2's engine
    stream, which must also equal ``generate``'s on the card; DeepSeek's
    capacity and dropless losses. Initialiser range 0.2, so the tiny
    models' greedy streams are not one repeated token; GPT-2 at 2 heads
    (D 32, which K12 takes)."""
    import dataclasses

    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import (DeepseekV2Config,
                                         DeepseekV2ForCausalLM, ErnieConfig,
                                         ErnieForPretraining, GPT2Config,
                                         GPT2ForCausalLM)
    rng = np.random.RandomState(21)
    families = {
        # two heads of 32: K12 takes head dims of 32-256, not tiny's 16
        "gpt2": (GPT2ForCausalLM, dataclasses.replace(
            GPT2Config.tiny(), initializer_range=0.2,
            num_attention_heads=2)),
        "ernie": (ErnieForPretraining, dataclasses.replace(
            ErnieConfig.tiny(), initializer_range=0.2)),
        "deepseek": (DeepseekV2ForCausalLM, dataclasses.replace(
            DeepseekV2Config.tiny(), num_hidden_layers=2,
            initializer_range=0.2)),
        "deepseek_dropless": (DeepseekV2ForCausalLM, dataclasses.replace(
            DeepseekV2Config.tiny(), num_hidden_layers=2,
            initializer_range=0.2, moe_dropless=True)),
    }
    for name, (cls, cfg) in families.items():
        weights = cls(cfg, device="cpu", seed=3).state_dict()
        vocab = cfg.vocab_size
        ids = rng.randint(5, vocab, (2, 48))
        labels = np.where(rng.rand(2, 48) < 0.2, ids, -100)
        sop = rng.randint(0, 2, 2)
        prompts = rng.randint(0, vocab, (2, 9))
        out = {}
        for d in ("cpu", dev):
            m = cls(cfg, device=d)
            m.load_state_dict(weights)
            t = torch.from_numpy(ids).to(d)
            if name == "ernie":
                loss = m(t, masked_lm_labels=torch.from_numpy(labels).to(d),
                         sop_labels=torch.from_numpy(sop).to(d))
            else:
                _, loss = m(t, labels=t)
            loss.backward()
            res = [loss.item(), convert.grads_to_numpy(m)]
            if name != "ernie":
                m.eval()
                res.append(m.generate(torch.from_numpy(prompts).to(d),
                                      max_new_tokens=12,
                                      decode_strategy="greedy_search")[
                                          0].tolist())
            if name == "gpt2":
                eng = ContinuousBatchingEngine(m, num_slots=2, page_size=8,
                                               max_len=64, decode_chunk=4,
                                               prompt_buckets=(16,),
                                               device=d)
                for p in prompts:
                    eng.add_request(p, 12)
                res.append([r.tokens for r in sorted(
                    eng.run(), key=lambda r: r.request_id)])
            out[d] = res
            del m
        (l0, g0, *s0), (l1, g1, *s1) = out["cpu"], out[dev]
        worst = max(float(np.linalg.norm(g1[k] - g0[k])
                          / max(np.linalg.norm(g0[k]), 1e-30)) for k in g0)
        # f32 on both sides, as train_parity: the loss within 1e-5 of
        # itself, each gradient within 1e-4 (whole-tensor relative)
        if abs(l1 - l0) > 1e-5 * abs(l0) or worst > 1e-4 or set(g0) != set(
                g1):
            raise AssertionError(f"[model_parity] {name}: loss {l1} vs "
                                 f"{l0}, worst gradient {worst:.3g}")
        if s1 != s0:
            raise AssertionError(f"[model_parity] {name}: greedy streams on "
                                 f"the card {s1} vs the CPU {s0}")
        if name == "gpt2" and s1[1] != s1[0]:
            raise AssertionError(f"[model_parity] gpt2: the engine's streams "
                                 f"{s1[1]} differ from generate's {s1[0]}")
        log(f"[model_parity] {name} tiny, depth "
            f"{cfg.num_hidden_layers}, f32: loss card {l1:.6f} vs CPU "
            f"{l0:.6f}; {len(g0)} grads, worst relative error {worst:.3g} "
            f"(limit 1e-4)"
            + ("; greedy generate streams identical" if s0 else "")
            + ("; the engine's streams identical to generate's on both"
               if name == "gpt2" else ""))
    torch.cuda.empty_cache()


TP_STEPS = 3                     # AdamW steps of every multi-rank case
TP_RESUMED = 2                   # steps after each resume (parts a, b)
# part (c) checkpoints the 8B's model state alone: with its f32 master
# weights and two f32 moments the state is about 27 GB (7x the bf16
# weights' 3.85 GB), over a minute more of writing and reading on the
# card's host within the script's time limit; the optimizer's resharding
# is held by parts (a) and (b), which save and load it whole
TP_8B_SAVE_OPTIMIZER = False
TP_BATCH = (2, 256)              # the f32 cases' global batch (tokens)
TP_TINY_BATCH = (4, 64)          # tiny Qwen2 / DeepSeek-V2 (64 positions)
TP_8B_LAYERS = 4                 # Llama-3-8B's depth cut so two ranks fit
TP_8B_IDS = (1, 2049)            # batch 1 x seq 2048 (+1 for the labels)
# f32 against the unsharded run on the card: the first step differs by
# the order of the sums (row-parallel partials all-reduced, the model
# group's max and sums of the CE), some 1e-7 of a value; AdamW's
# normalised updates carry it into the next steps' losses
TP_F32_RTOL = (1e-5, 1e-4)
# bf16: the sharded matmuls and the gloo sums (in f32) round in other
# places than the unsharded ones; the first loss (about 12) may move by a
# few bf16 roundings of the hidden state, some 1e-4 of itself
TP_BF16_RTOL = 5e-3
TP_CASES = (
    # name, family, hybrid degrees, group_sharded_parallel level, fields
    ("llama mp2", "llama", {"mp_degree": 2}, None, {}),
    ("llama mp2 sp", "llama", {"mp_degree": 2}, None,
     {"sequence_parallel": True}),
    ("llama sharding2 stage2", "llama",
     {"sharding_degree": 2, "dp_degree": 1}, "os_g", {}),
    ("llama sharding2 stage3", "llama",
     {"sharding_degree": 2, "dp_degree": 1}, "p_g_os", {}),
    ("llama dp2", "llama", {"dp_degree": 2}, None, {}),
    ("qwen2 tiny mp2", "qwen2", {"mp_degree": 2}, None, {}),
    ("deepseek tiny mp2", "deepseek", {"mp_degree": 2}, None, {}))


def _tp_model(family, cfg, dtype, seed=7):
    from paddle_tpu_torch.models import (DeepseekV2ForCausalLM,
                                         LlamaForCausalLM, Qwen2ForCausalLM)
    cls = {"llama": LlamaForCausalLM, "qwen2": Qwen2ForCausalLM,
           "deepseek": DeepseekV2ForCausalLM}[family]
    return cls(cfg, device="cuda", dtype=dtype, seed=seed)


def _tp_configs(cfg1b):
    """Each case's config: Llama-1B's width at depth 1 (2 until its
    checkpoints came in), the tiny Qwen2 and DeepSeek-V2, tensor parallel
    where the family has the switch."""
    import dataclasses

    from paddle_tpu_torch.models import DeepseekV2Config, Qwen2Config
    llama = dataclasses.replace(cfg1b, num_hidden_layers=1)
    return {"llama": llama,
            "qwen2": dataclasses.replace(Qwen2Config.tiny(),
                                         tensor_parallel=True),
            "deepseek": dataclasses.replace(DeepseekV2Config.tiny(),
                                            tensor_parallel=True)}


def _tp_batches(cfg, shape, seed):
    """The batches of the ``TP_STEPS`` steps, then of ``TP_RESUMED``
    more after a resume."""
    return [np.random.RandomState(seed + s).randint(
        0, cfg.vocab_size, shape).astype(np.int64)
        for s in range(TP_STEPS + TP_RESUMED)]


def _tp_written(path, rank):
    """Bytes of the shard files rank ``rank`` wrote into the committed
    checkpoint ``path``."""
    with open(os.path.join(path, f"meta.{rank}.json")) as f:
        meta = json.load(f)
    return sum(sh["nbytes"] for e in meta.values()
               if e.get("kind") == "tensor" for sh in e["shards"])


def _tp_resume(family, cfg, path, batches, rep=0, n_rep=1, wrap=False):
    """A model of ``family`` from another seed (f32; split under the
    initialised fleet when ``wrap``), ``hapi.Model.load_checkpoint(path)``
    and the ``TP_RESUMED`` steps after it: (losses, load seconds, the
    optimizer's step count after the load)."""
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    model = _tp_model(family, cfg, torch.float32, seed=11)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    if wrap:
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    m = Model(model)
    m.prepare(opt)
    t0 = time.perf_counter()
    m.load_checkpoint(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    step0 = opt._step_count
    losses = _tp_train(model, opt, batches[TP_STEPS:], rep, n_rep)
    return losses, load_s, step0


def _tp_train(model, opt, batches, rep=0, n_rep=1, times=None):
    """AdamW steps on each global batch's rows of data replica ``rep``:
    the local losses (and each step's ms into ``times``)."""
    import torch
    losses = []
    for ids in batches:
        rows = ids.shape[0] // n_rep
        t = torch.from_numpy(ids[rep * rows:(rep + 1) * rows]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = model(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    return losses


def _tp_fleet(hybrid):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(hybrid)
    fleet.init(is_collective=True, strategy=strategy)


def _tp_ce_checks(n, vc, los, rand):
    """K10 and K11 at a vocab shard's chunk ([n, vc] logits, each ``lo``
    of the shard's chunk grid) in bf16 against their plain versions, with
    phase_fused_kernels' limits: m and t exact, s 2e-5 of itself, dlogits
    one ulp of each |ref|. Returns the largest errors."""
    import torch
    from paddle_tpu_torch.ops.kernels import ce_chunk as kce
    errs = {}
    for lo in los:
        logits = rand(n, vc, dtype=torch.bfloat16) * 3
        local = torch.randint(lo, vc, (n,), device="cuda",
                              dtype=torch.int32)
        # labels on other ranks' shards (below 0, past vc) and at the
        # chunk's edges
        local[:4] = torch.tensor([-64128, vc + 70000, lo, vc - 1],
                                 dtype=torch.int32)
        m, s_, t = kce.chunk_stats(logits, local, lo)
        rm, rs_, rt = kce.chunk_stats_reference(logits, local, lo)
        if not (torch.equal(m, rm) and torch.equal(t, rt)):
            raise AssertionError(f"[tp] chunk_stats lo={lo}: max or target "
                                 f"differs")
        err, _ = check_close(f"[tp] chunk_stats lo={lo}", s_, rs_,
                             2e-5 * rs_)
        errs["chunk_stats"] = max(errs.get("chunk_stats", 0.0), err)
        lse = rm + torch.log(rs_)
        scale = torch.full((n,), 1.0 / n, device="cuda")
        out = kce.chunk_dlogits(logits, lse, local, scale, lo)
        ref = kce.chunk_dlogits_reference(logits, lse, local, scale, lo)
        err, _ = check_close(f"[tp] chunk_dlogits lo={lo}", out, ref,
                             BF16_ULP * ref.float().abs() + 1e-12)
        errs["chunk_dlogits"] = max(errs.get("chunk_dlogits", 0.0), err)
    return errs


def _tp_shard_checks(cfg8):
    """K7-K9 at a rank's heads of ``cfg8`` at mp 2 and K10/K11 at its
    vocab shard's chunks, against their plain versions."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(97)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    nh = cfg8.num_attention_heads // 2
    kvh = cfg8.num_key_value_heads // 2
    seq = TP_8B_IDS[1] - 1
    flash = flash_checks(1, seq, nh, kvh, cfg8.head_dim, rand)
    out = {k: {"max_abs_err": v["max_abs_err"],
               "shape": f"q[1,{seq},{nh},{cfg8.head_dim}] kv {kvh} heads"}
           for k, v in flash.items()}
    # the vocab shard's chunk grid: 64128 columns in chunks of 1024, the
    # last one clamped back (lo 384)
    v_local = cfg8.vocab_size // 2
    lo_tail = 1024 * (-(-v_local // 1024) - 1) - (v_local - 1024)
    for k, err in _tp_ce_checks(seq - 1, 1024, (0, lo_tail), rand).items():
        out[k] = {"max_abs_err": err, "shape": f"logits[{seq - 1},1024] of "
                  f"a {v_local}-column shard, lo 0/{lo_tail}"}
    return out


def tp_rank(out_dir, cfg1b, cfg8, ref_ck, cfg_sep):
    """One rank of phase tp (``distributed.spawn``): the f32 cases, each
    saved after its steps (``hapi.Model.save_checkpoint`` into
    ``out_dir/case<i>``; the plain mp 2 ones then resume from the
    unsharded reference's checkpoint ``ref_ck[family]`` and take
    ``TP_RESUMED`` steps), then Llama-3-8B's width at mp 2 in bf16, its
    state saved into ``out_dir/ck8b`` before one step more; rank 0 then
    holds K7-K11 at the shard shapes against their plain versions.
    Writes ``out_dir/rank<r>.json``; a failure exits nonzero."""
    global HBM_BYTES_PER_S, PEAK_BF16
    import dataclasses
    import shutil

    import torch
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.distributed import env, fleet, get_backend
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import data_replicas
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import cost
    _matmul_settings()
    peaks = cost.device_peaks()
    HBM_BYTES_PER_S, PEAK_BF16 = peaks.hbm_bw, peaks.flops
    t0 = time.perf_counter()
    env.init_parallel_env()
    rank = env.get_rank()
    _build.build()
    out = {"rank": rank, "backend": get_backend(),
           "device": str(env.current_device()), "cases": {},
           "build_s": _build.build_seconds(), "compiled": bool(
               _build.build_log())}
    cfgs = _tp_configs(cfg1b)
    for i, (name, family, hybrid, level, fields) in enumerate(TP_CASES):
        _tp_fleet(hybrid)
        cfg = dataclasses.replace(cfgs[family], **fields)
        model = _tp_model(family, cfg, torch.float32)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    weight_decay=0.01)
        if level:
            model, opt, _ = group_sharded_parallel(model, opt, level=level)
        else:
            model = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
        n_rep, rep = data_replicas()
        shape = TP_BATCH if family == "llama" else TP_TINY_BATCH
        batches = _tp_batches(cfg, shape, 30)
        case = out["cases"][name] = {"rep": rep, "losses": _tp_train(
            model, opt, batches[:TP_STEPS], rep, n_rep)}
        # (a) this layout's checkpoint, which the parent resumes unsharded
        m = Model(model)
        m.prepare(opt)
        path = os.path.join(out_dir, f"case{i}")
        t1 = time.perf_counter()
        m.save_checkpoint(path, epoch=0)
        case["save_s"] = time.perf_counter() - t1
        case["save_bytes"] = _tp_written(path, rank)
        del m, model, opt
        torch.cuda.empty_cache()
        if hybrid == {"mp_degree": 2} and not fields:
            # (b) the unsharded reference's checkpoint, resumed at mp 2
            case["resumed"], case["load_s"], case["step0"] = _tp_resume(
                family, cfg, ref_ck[family], batches, rep, n_rep, wrap=True)
            torch.cuda.empty_cache()
    out["cases_s"] = time.perf_counter() - t0
    _tp_fleet({"mp_degree": 2})
    flags.set_flags({"FLAGS_fused_linear_cross_entropy": True})
    t1 = time.perf_counter()
    model = LlamaForCausalLM(cfg8, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        weight_decay=0.01))
    out["params"] = sum(p.numel() for p in model.parameters())
    out["build_8b_s"] = time.perf_counter() - t1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = _counted(TRAIN_KERNELS)
    times = []
    batches8 = _tp_batches(cfg8, TP_8B_IDS, 0)
    out["losses_8b"] = _tp_train(model, opt, batches8[:TP_STEPS],
                                 times=times)
    out["launches"] = {n: w.launches for n, w in wrappers.items()}
    out["ms"], out["peak_gb"] = times, torch.cuda.max_memory_allocated() / 1e9
    # (c) the 8B's checkpoint, then the ranks' own next step
    state = {"model": model.state_dict()}
    if TP_8B_SAVE_OPTIMIZER:
        state["optimizer"] = opt.state_dict()
    ck8 = os.path.join(out_dir, "ck8b")
    out["disk_free_gb"] = shutil.disk_usage(out_dir).free / 1e9
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dckpt.save_state_dict(state, ck8)
    out["save_8b_s"] = time.perf_counter() - t1
    out["save_8b_bytes"] = _tp_written(ck8, rank)
    del state
    out["losses_8b"] += _tp_train(model, opt, batches8[TP_STEPS:][:1])
    flags.set_flags({"FLAGS_fused_linear_cross_entropy": False})
    del model, opt
    torch.cuda.empty_cache()
    if rank == 0:
        out["kernels"] = _tp_shard_checks(cfg8)
    out["pp"] = pp_rank(out_dir, cfg1b, cfg8)
    out["sep"] = sep_rank(out_dir, cfg1b, cfg_sep)
    out["ep"] = ep_rank(out_dir)
    out["total_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_tp(cfg, cfg1b):
    """Two ranks share the card through ``distributed.spawn`` (the backend
    rule takes gloo, collectives through host buffers). First, in this
    process, the unsharded runs the ranks are held to: each f32 case's
    model from its seed through the same AdamW steps on the whole batch,
    and Llama-3-8B's width at 4 layers in bf16 (fused carry, core_attn
    recompute, the fused linear+CE) through the same steps; its memory is
    freed before the spawn. The ranks (``tp_rank``) load the kernels built
    here, run each f32 case split (mp 2, mp 2 with sequence parallelism,
    ZeRO stage 2 and 3 over sharding 2, dp 2 with the batch split, tiny
    Qwen2 and DeepSeek-V2 at mp 2) and then the 8B at mp 2 with the
    vocab-parallel fused CE, counting K1-K11's launches; rank 0 holds
    K7-K11 at the shard shapes against their plain versions.

    Checkpoints across layouts (``distributed.checkpoint``'s multi-rank
    protocol): (a) each f32 case's ranks save after their steps, and this
    process loads each checkpoint into the unsharded model and takes
    ``TP_RESUMED`` steps, held to the reference's own next steps; (b) the
    unsharded references save after ``TP_STEPS`` steps (the Llama's save
    async, its writer running beside the next steps), and the ranks load
    them at mp 2 and take the same steps; (c) the 8B's ranks save their
    state, take one step more, and this process loads it at mp 1 and
    takes that step in bf16.

    Then the pp cases (``pp_rank``), the sep cases (``sep_rank``: a
    third ``fleet.init`` at sep 2 on the same two ranks, held to
    ``_sep_references``' unpartitioned runs) and the ep cases
    (``ep_rank``: a fourth at ep 2, held to ``_ep_references``; the f32
    Qwen2-MoE's ep 2 checkpoint resumed unpartitioned here,
    ``_ep_resume``). pp 2 x sep 2, pp 2 x ep 2 and ep 2 with mp 2 or dp 2
    need four ranks, so they run in the CPU tests only."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    cfgs = _tp_configs(cfg1b)
    ck_root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    refs, ref_ck, ref_save = {}, {}, {}
    for family, c in cfgs.items():
        model = _tp_model(family, c, torch.float32)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    weight_decay=0.01)
        shape = TP_BATCH if family == "llama" else TP_TINY_BATCH
        batches = _tp_batches(c, shape, 30)
        refs[family] = _tp_train(model, opt, batches[:TP_STEPS])
        m = Model(model)
        m.prepare(opt)
        ref_ck[family] = os.path.join(ck_root, f"ref_{family}")
        t1 = time.perf_counter()
        dckpt.save_state_dict(m._checkpoint_state(epoch=0), ref_ck[family],
                              async_save=family == "llama")
        ref_save[family] = time.perf_counter() - t1
        refs[family] += _tp_train(model, opt, batches[TP_STEPS:])
        del m, model, opt
    t1 = time.perf_counter()
    dckpt.wait_async_save()
    ref_save["llama wait"] = time.perf_counter() - t1
    cfg8 = dataclasses.replace(cfg, num_hidden_layers=TP_8B_LAYERS,
                               use_recompute=True,
                               recompute_granularity="core_attn")
    flags.set_flags({"FLAGS_fused_linear_cross_entropy": True})
    try:
        model = _tp_model("llama", cfg8, torch.bfloat16, seed=0)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01)
        torch.cuda.reset_peak_memory_stats()
        times = []
        ref8 = _tp_train(model, opt,
                         _tp_batches(cfg8, TP_8B_IDS, 0)[:TP_STEPS],
                         times=times)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(p.numel() for p in model.parameters())
        del model, opt
    finally:
        flags.set_flags({"FLAGS_fused_linear_cross_entropy": False})
    torch.cuda.empty_cache()
    log(f"[tp] unsharded on the card: Llama-3-8B width at {TP_8B_LAYERS} "
        f"layers ({n_params / 1e9:.3f} B parameters), bf16, [1, 2048]: "
        f"losses {', '.join(f'{x:.6f}' for x in ref8)}, ms a step "
        f"{', '.join(f'{x:.1f}' for x in times)}, peak {peak:.2f} GB; "
        f"references in {time.perf_counter() - t0:.1f} s")
    pp_refs = _pp_references(cfg1b, cfg8)
    sep_refs = _sep_references(cfg1b, cfg)
    ep_refs = _ep_references()
    out_dir = ck_root
    t1 = time.perf_counter()
    procs = spawn(tp_rank, args=(out_dir, cfg1b, cfg8, ref_ck, cfg),
                  nprocs=2, join=False)
    try:
        # (a) beside the ranks: each case's checkpoint as it commits
        resumed = _tp_resumes(cfgs, out_dir, refs, procs, t1 + 900)
        _tp_join(procs, t1 + 900)
        spawn_s = time.perf_counter() - t1
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        part_c = _tp_8b_resume(cfg8, out_dir, ranks)
        pp_resumed = _pp_resume(cfg1b, out_dir)
        ep_resumed = _ep_resume(out_dir)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(ck_root, ignore_errors=True)
    for rk in ranks:
        if rk["backend"] != "gloo" or rk["compiled"]:
            raise AssertionError(f"[tp] rank {rk['rank']}: backend "
                                 f"{rk['backend']} (two ranks on one card "
                                 f"take gloo), compiled {rk['compiled']} "
                                 f"(the ranks load this process's build)")
    worst = 0.0
    for name, family, hybrid, level, fields in TP_CASES:
        by_rep = {}
        for rk in ranks:
            by_rep.setdefault(rk["cases"][name]["rep"],
                              rk["cases"][name]["losses"])
        got = np.mean([by_rep[k] for k in sorted(by_rep)], axis=0)
        want = np.asarray(refs[family][:TP_STEPS])
        rel = np.abs(got - want) / np.abs(want)
        lim = np.array([TP_F32_RTOL[0]] + [TP_F32_RTOL[1]] * (TP_STEPS - 1))
        worst = max(worst, float((rel / lim).max()))
        if (rel > lim).any():
            raise AssertionError(f"[tp] {name}: losses {got.tolist()} "
                                 f"against the unsharded {want.tolist()}")
        log(f"[tp] {name} ({hybrid}{', ' + str(fields) if fields else ''}"
            f"{', level ' + level if level else ''}"
            f"): losses {', '.join(f'{x:.7f}' for x in got)} against the "
            f"unsharded {', '.join(f'{x:.7f}' for x in want)}, worst "
            f"relative {rel.max():.3g} (limits {TP_F32_RTOL[0]:g} at the "
            f"first step, {TP_F32_RTOL[1]:g} after)")
    for name, family, hybrid, level, fields in TP_CASES:
        _tp_check_resumes(name, family, ranks, resumed[name], refs)
    first = ranks[0]["losses_8b"][0]
    rel8 = abs(first - ref8[0]) / abs(ref8[0])
    if rel8 > TP_BF16_RTOL or ranks[1]["losses_8b"] != ranks[0]["losses_8b"]:
        raise AssertionError(f"[tp] 8B mp2: first loss {first} against the "
                             f"unsharded {ref8[0]} (limit {TP_BF16_RTOL}), "
                             f"ranks {ranks[0]['losses_8b']} / "
                             f"{ranks[1]['losses_8b']}")
    launches = {n: sum(rk["launches"][n] for rk in ranks)
                for n in TRAIN_KERNELS}
    for rk in ranks:
        log(f"[tp] rank {rk['rank']} on {rk['device']}, backend "
            f"{rk['backend']}: Llama-3-8B width mp 2 at {TP_8B_LAYERS} "
            f"layers ({rk['params'] / 1e9:.3f} B parameters a rank), bf16, "
            f"[1, 2048], fused carry, core_attn recompute, vocab-parallel "
            f"fused CE: losses {', '.join(f'{x:.6f}' for x in rk['losses_8b'])}"
            f", ms a step {', '.join(f'{x:.1f}' for x in rk['ms'])}, peak "
            f"{rk['peak_gb']:.2f} GB; launches in {TP_STEPS} steps "
            f"{rk['launches']}; built in {rk['build_8b_s']:.1f} s, the f32 "
            f"cases in {rk['cases_s']:.1f} s, the rank in "
            f"{rk['total_s']:.1f} s")
    _tp_log_8b(ranks, part_c)
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"[tp] kernels not launched on the mp 2 path: "
                             f"{missing}")
    log(f"[tp] first 8B loss {first:.6f} against the unsharded "
        f"{ref8[0]:.6f}: relative {rel8:.3g} (limit {TP_BF16_RTOL:g}); f32 "
        f"cases worst err/limit {worst:.3g}; spawn to exit {spawn_s:.1f} s")
    log(f"[tp] (b) the unsharded references' checkpoints after step "
        f"{TP_STEPS}: saved in "
        + ", ".join(f"{k} {v:.2f} s" for k, v in ref_save.items())
        + " (the Llama's async: the call, then the wait after its next "
        f"{TP_RESUMED} steps)")
    pp_launches = _pp_check([rk["pp"] for rk in ranks], pp_refs, pp_resumed)
    sep_launches = _sep_check([rk["sep"] for rk in ranks], sep_refs, refs)
    ep_launches = _ep_check([rk["ep"] for rk in ranks], ep_refs, ep_resumed)
    kernels = dict(ranks[0]["kernels"])
    for name, entry in ranks[0]["sep"]["kernels"].items():
        kernels[name + " sep2"] = entry
    return {"launches": launches, "launches_pp": pp_launches,
            "launches_sep": sep_launches, "launches_ep": ep_launches,
            "kernels": kernels}


def _tp_join(procs, deadline, until=None):
    """Wait for the ranks ``procs`` to exit 0 (or, with ``until``, for
    ``until()`` to hold while they run); raises if one exits nonzero or
    the deadline passes."""
    while until is None or not until():
        bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        if bad:
            raise RuntimeError(f"[tp] a rank exited nonzero ({bad})")
        if until is None and all(p.exitcode == 0 for p in procs):
            return
        if time.perf_counter() > deadline:
            raise TimeoutError("[tp] the ranks did not finish in time")
        time.sleep(0.1)


def _tp_resumes(cfgs, out_dir, refs, procs, deadline):
    """(a) Each case's checkpoint, once the ranks have committed it,
    loaded into the unsharded f32 model, then ``TP_RESUMED`` steps:
    {case: (losses, load s, step count, bytes read)}. Each checkpoint is
    removed after its load."""
    import shutil

    import torch
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.distributed.checkpoint.validation import \
        _read_metas
    out = {}
    for i, (name, family, hybrid, level, fields) in enumerate(TP_CASES):
        path = os.path.join(out_dir, f"case{i}")
        _tp_join(procs, deadline, until=lambda: dckpt.is_committed(path))
        shape = TP_BATCH if family == "llama" else TP_TINY_BATCH
        nbytes = sum(sh["nbytes"] for e in _read_metas(path).values()
                     if e.get("kind") == "tensor" for sh in e["shards"])
        losses, load_s, step0 = _tp_resume(
            family, cfgs[family], path, _tp_batches(cfgs[family], shape, 30))
        out[name] = (losses, load_s, step0, nbytes)
        shutil.rmtree(path)
        torch.cuda.empty_cache()
    return out


def _tp_check_resumes(name, family, ranks, resumed, refs):
    """Parts (a) and (b) of one case against the reference's steps after
    ``TP_STEPS``, within ``TP_F32_RTOL[1]``."""
    want = np.asarray(refs[family][TP_STEPS:])
    losses, load_s, step0, nbytes = resumed
    parts = [("(a) unsharded from its checkpoint", np.asarray(losses),
              step0)]
    for rk in ranks:
        case = rk["cases"][name]
        if "resumed" in case:
            parts.append((f"(b) rank {rk['rank']} from the unsharded "
                          "checkpoint", np.asarray(case["resumed"]),
                          case["step0"]))
    for tag, got, s0 in parts:
        rel = np.abs(got - want) / np.abs(want)
        if (rel > TP_F32_RTOL[1]).any() or s0 != TP_STEPS:
            raise AssertionError(
                f"[tp] {name} {tag}: losses {got.tolist()} against the "
                f"reference's {want.tolist()}, optimizer step {s0}")
    saved = [rk["cases"][name] for rk in ranks]
    log(f"[tp] {name}: saved by the ranks in "
        f"{', '.join(f'{c['save_s']:.2f} s ({c['save_bytes'] / 1e9:.3f} GB)' for c in saved)}; "
        + "; ".join(f"{tag}: steps {TP_STEPS + 1}-{TP_STEPS + TP_RESUMED} "
                    f"losses {', '.join(f'{x:.7f}' for x in got)}, "
                    f"optimizer step {s0} after the load"
                    for tag, got, s0 in parts)
        + f" against the reference's {', '.join(f'{x:.7f}' for x in want)}"
        f" (limit {TP_F32_RTOL[1]:g}); the unsharded load read "
        f"{nbytes / 1e9:.3f} GB in {load_s:.2f} s"
        + "".join(f", rank {rk['rank']}'s load {rk['cases'][name]['load_s']:.2f} s"
                  for rk in ranks if "load_s" in rk["cases"][name]))


def _tp_8b_resume(cfg8, out_dir, ranks):
    """(c) The 8B's mp 2 checkpoint loaded at mp 1 in bf16 and one step
    on the batch of the ranks' step ``TP_STEPS + 1``: its loss, the load's
    seconds and bytes, and the reshard gauges."""
    import torch
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.distributed.checkpoint.validation import \
        _read_metas
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import metrics as pmetrics
    path = os.path.join(out_dir, "ck8b")
    reg = pmetrics.get_registry()
    for g in ("elastic/reshard_tensors", "elastic/reshard_ms"):
        reg.gauge(g).set(0)
    flags.set_flags({"FLAGS_fused_linear_cross_entropy": True})
    try:
        model = _tp_model("llama", cfg8, torch.bfloat16, seed=1)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01)
        state = {"model": model.state_dict()}
        if TP_8B_SAVE_OPTIMIZER:
            from paddle_tpu_torch.hapi import Model
            m = Model(model)
            m.prepare(opt)
            t0 = time.perf_counter()
            m.load_checkpoint(path)
        else:
            t0 = time.perf_counter()
            dckpt.load_state_dict(state, path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        nbytes = sum(sh["nbytes"] for e in _read_metas(path).values()
                     if e.get("kind") == "tensor" for sh in e["shards"])
        loss = _tp_train(model, opt, _tp_batches(cfg8, TP_8B_IDS, 0)[
            TP_STEPS:][:1])[0]
        del model, opt, state
    finally:
        flags.set_flags({"FLAGS_fused_linear_cross_entropy": False})
    torch.cuda.empty_cache()
    want = ranks[0]["losses_8b"][TP_STEPS]
    rel = abs(loss - want) / abs(want)
    if rel > TP_BF16_RTOL:
        raise AssertionError(f"[tp] (c) the 8B resumed at mp 1: loss {loss} "
                             f"against the ranks' step {TP_STEPS + 1} "
                             f"{want} (limit {TP_BF16_RTOL})")
    return {"loss": loss, "rel": rel, "load_s": load_s, "bytes": nbytes,
            "reshard_tensors": reg.gauge("elastic/reshard_tensors").value,
            "reshard_ms": reg.gauge("elastic/reshard_ms").value}


def _tp_log_8b(ranks, part_c):
    what = "model and optimizer" if TP_8B_SAVE_OPTIMIZER else \
        "model (TP_8B_SAVE_OPTIMIZER off)"
    log(f"[tp] (c) Llama-3-8B width mp 2 -> mp 1, {what} state: disk free "
        f"before the save {ranks[0]['disk_free_gb']:.1f} GB; saved by rank "
        + ", rank ".join(f"{rk['rank']} in {rk['save_8b_s']:.2f} s "
                         f"({rk['save_8b_bytes'] / 1e9:.3f} GB)"
                         for rk in ranks)
        + f"; loaded by one process in {part_c['load_s']:.2f} s "
        f"({part_c['bytes'] / 1e9:.3f} GB), elastic/reshard_tensors "
        f"{part_c['reshard_tensors']}, elastic/reshard_ms "
        f"{part_c['reshard_ms']}; step {TP_STEPS + 1} loss "
        f"{part_c['loss']:.6f} against the ranks' "
        f"{ranks[0]['losses_8b'][TP_STEPS]:.6f}: relative "
        f"{part_c['rel']:.3g} (limit {TP_BF16_RTOL:g})")


PP_SCHEDULES = (("FThenB", None), ("1F1B", None), ("ZB-H1", None),
                ("interleaved", 2))
PP_LAYERS = 4                    # Llama-1B's width: 2 layers a stage
PP_8B_IDS = (4, 2049)            # 4 microbatches of [1, 2048]
PP_8B_STEPS = 2


def _pp_configs(cfg1b):
    """The f32 Llama (Llama-1B's width at ``PP_LAYERS``) and the tiny
    Qwen2-MoE (dropless, so K14/K15 run; aux loss 0, as the pipe folds
    it out) of the pp cases."""
    import dataclasses

    from paddle_tpu_torch.models import Qwen2MoeConfig
    return (dataclasses.replace(cfg1b, num_hidden_layers=PP_LAYERS),
            dataclasses.replace(Qwen2MoeConfig.tiny(), num_hidden_layers=4,
                                moe_dropless=True, router_aux_loss_coef=0.0))


def _pp_references(cfg1b, cfg8):
    """The unpartitioned runs the pp ranks are held to, in this process
    before the spawn (their memory freed after): the f32 Llama from seed
    7 through ``TP_STEPS + TP_RESUMED`` AdamW steps, the tiny Qwen2-MoE
    through ``TP_STEPS``, and the 8B width in bf16 from seed 0 through
    ``PP_8B_STEPS`` on ``PP_8B_IDS``."""
    import torch
    from paddle_tpu_torch.models import Qwen2MoeForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    llama, moe = _pp_configs(cfg1b)
    out = {}
    for name, model, shape in (
            ("llama", _tp_model("llama", llama, torch.float32), TP_BATCH),
            ("moe", Qwen2MoeForCausalLM(moe, device="cuda", seed=7),
             TP_TINY_BATCH)):
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    weight_decay=0.01)
        batches = _tp_batches(model.config, shape, 30)
        out[name] = _tp_train(model, opt, batches if name == "llama"
                              else batches[:TP_STEPS])
        del model, opt
    model = _tp_model("llama", cfg8, torch.bfloat16, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    torch.cuda.reset_peak_memory_stats()
    times = []
    out["8b"] = _tp_train(model, opt, _tp_batches(cfg8, PP_8B_IDS, 0)[
        :PP_8B_STEPS], times=times)
    out["8b_ms"], out["8b_peak_gb"] = times, \
        torch.cuda.max_memory_allocated() / 1e9
    del model, opt
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def _pp_fleet(schedule, micro, virtual=None):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(pp_degree=2, dp_degree=1)
    strategy.pipeline_configs.update(
        schedule_mode=schedule, accumulate_steps=micro,
        num_virtual_pipeline_stages=virtual)
    fleet.init(is_collective=True, strategy=strategy)


def _pp_steps(model, opt, batches, times=None):
    """``train_batch`` on each batch: the mean losses (and ms a step)."""
    import torch
    losses = []
    for ids in batches:
        t = torch.from_numpy(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(model.train_batch((t, t), opt)))
        if times is not None:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return losses


def pp_rank(out_dir, cfg1b, cfg8):
    """The pp cases on one rank of phase tp, after its mp cases, with
    every kernel count at 0 first: a second ``fleet.init`` (pp 2) for
    each, the f32 Llama under each of ``PP_SCHEDULES`` (the 1F1B case
    saved into ``out_dir/pp_1f1b`` after its steps), the Qwen2-MoE pipe,
    then the 8B width in bf16. Returns the losses, launches, ms, peak
    memory and parameter counts."""
    import torch
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import (LlamaForCausalLMPipe,
                                         Qwen2MoeForCausalLMPipe)
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    rank = env.get_rank()
    wrappers = _counted(TRAIN_KERNELS + MOE_KERNELS)
    llama, moe = _pp_configs(cfg1b)
    out = {"cases": {}}

    def build(make, cfg, lr, **kw):
        layer = make(cfg, device="cuda", **kw)
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=lr, parameters=layer.parameters(),
            weight_decay=0.01))
        return layer, fleet.distributed_model(layer), opt

    batches = _tp_batches(llama, TP_BATCH, 30)
    for schedule, virtual in PP_SCHEDULES:
        _pp_fleet(schedule, TP_BATCH[0], virtual)
        layer, model, opt = build(LlamaForCausalLMPipe, llama, 1e-3, seed=7,
                                  num_virtual_pipeline_stages=virtual)
        case = out["cases"][schedule] = {
            "losses": _pp_steps(model, opt, batches[:TP_STEPS]),
            "peak_live": model.peak_live,
            "params": sum(p.numel() for p in layer.parameters()),
            "by_stage": [sum(p.numel() for p in ps)
                         for ps in layer.parameters_by_stage]}
        if schedule == "1F1B":
            m = Model(layer)
            m.prepare(opt)
            path = os.path.join(out_dir, "pp_1f1b")
            t1 = time.perf_counter()
            m.save_checkpoint(path, epoch=0)
            case["save_s"] = time.perf_counter() - t1
            case["save_bytes"] = _tp_written(path, rank)
            del m
        del layer, model, opt
        torch.cuda.empty_cache()
    _pp_fleet("1F1B", 2)
    layer, model, opt = build(Qwen2MoeForCausalLMPipe, moe, 1e-3, seed=7)
    out["moe_losses"] = _pp_steps(model, opt, _tp_batches(
        moe, TP_TINY_BATCH, 30)[:TP_STEPS])
    del layer, model, opt
    torch.cuda.empty_cache()
    out["f32_s"] = time.perf_counter() - t0
    _pp_fleet("1F1B", PP_8B_IDS[0])
    t1 = time.perf_counter()
    layer, model, opt = build(LlamaForCausalLMPipe, cfg8, 1e-4,
                              dtype=torch.bfloat16, seed=0)
    out["build_8b_s"] = time.perf_counter() - t1
    out["params_8b"] = sum(p.numel() for p in layer.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: w.launches for n, w in wrappers.items()}
    times = []
    out["losses_8b"] = _pp_steps(model, opt, _tp_batches(
        cfg8, PP_8B_IDS, 0)[:PP_8B_STEPS], times)
    out["launches_8b"] = {n: w.launches - before[n]
                          for n, w in wrappers.items()}
    out["ms_8b"] = times
    out["peak_gb_8b"] = torch.cuda.max_memory_allocated() / 1e9
    del layer, model, opt
    torch.cuda.empty_cache()
    out["launches"] = {n: w.launches for n, w in wrappers.items()}
    out["stage"] = fleet.get_hybrid_communicate_group().get_stage_id()
    out["s"] = time.perf_counter() - t0
    return out


def _pp_resume(cfg1b, out_dir):
    """The 1F1B case's pp 2 checkpoint loaded into ``LlamaForCausalLM``
    (f32, another seed; the layer's keys through ``pipe_key``, the
    optimizer's keys the same at every pp degree), then ``TP_RESUMED``
    steps: (losses, load seconds, the optimizer's step count)."""
    import torch
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.models.llama import pipe_key
    from paddle_tpu_torch.optimizer import AdamW
    llama, _ = _pp_configs(cfg1b)
    path = os.path.join(out_dir, "pp_1f1b")
    model = _tp_model("llama", llama, torch.float32, seed=11)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    t0 = time.perf_counter()
    dckpt.load_state_dict({"model": {
        pipe_key(PP_LAYERS, "llama.", k): v
        for k, v in model.state_dict().items()}}, path)
    opt.set_state_dict(dckpt.read_state_dict(path, prefix="optimizer"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    step0 = opt._step_count
    losses = _tp_train(model, opt, _tp_batches(llama, TP_BATCH, 30)[
        TP_STEPS:])
    del model, opt
    torch.cuda.empty_cache()
    return losses, load_s, step0


def _pp_check(ranks, refs, resumed):
    """The pp cases of both ranks against the unpartitioned runs, logged
    beside the card's name and power limit; returns the launches of the
    pp path summed over the ranks (K1-K9 and K14/K15 must be there)."""
    def rel(got, want):
        return np.abs(np.asarray(got) - np.asarray(want)) / \
            np.abs(np.asarray(want))

    lim = np.array([TP_F32_RTOL[0]] + [TP_F32_RTOL[1]] * (TP_STEPS - 1))
    want = refs["llama"][:TP_STEPS]
    for schedule, _ in PP_SCHEDULES:
        for rk in ranks:
            case = rk["cases"][schedule]
            r = rel(case["losses"], want)
            if (r > lim).any() or case["params"] != \
                    case["by_stage"][rk["stage"]]:
                raise AssertionError(
                    f"[pp] {schedule} stage {rk['stage']}: losses "
                    f"{case['losses']} against the unpartitioned {want}, "
                    f"{case['params']} parameters held, by stage "
                    f"{case['by_stage']}")
        log(f"[pp] Llama-1B width at {PP_LAYERS} layers f32, pp 2, "
            f"{schedule}, {TP_BATCH[0]} microbatches: losses "
            f"{', '.join(f'{x:.7f}' for x in ranks[0]['cases'][schedule]['losses'])}"
            f" against the unpartitioned "
            f"{', '.join(f'{x:.7f}' for x in want)}: worst relative "
            f"{max(rel(rk['cases'][schedule]['losses'], want).max() for rk in ranks):.3g}"
            f" (limits {TP_F32_RTOL[0]:g} first, {TP_F32_RTOL[1]:g} after); "
            f"parameters a stage {ranks[0]['cases'][schedule]['by_stage']}; "
            f"peak live microbatches "
            f"{[rk['cases'][schedule]['peak_live'] for rk in ranks]}")
    losses, load_s, step0 = resumed
    want_r = refs["llama"][TP_STEPS:]
    r = rel(losses, want_r)
    saved = [rk["cases"]["1F1B"] for rk in ranks]
    if (r > TP_F32_RTOL[1]).any() or step0 != TP_STEPS:
        raise AssertionError(f"[pp] the 1F1B checkpoint resumed "
                             f"unpartitioned: losses {losses} against "
                             f"{want_r}, optimizer step {step0}")
    log(f"[pp] the 1F1B ranks' checkpoint (saved in "
        + ", ".join(f"{c['save_s']:.2f} s ({c['save_bytes'] / 1e9:.3f} GB)"
                    for c in saved)
        + f") loaded into LlamaForCausalLM in {load_s:.2f} s: steps "
        f"{TP_STEPS + 1}-{TP_STEPS + TP_RESUMED} losses "
        f"{', '.join(f'{x:.7f}' for x in losses)} against the "
        f"unpartitioned {', '.join(f'{x:.7f}' for x in want_r)}, worst "
        f"relative {r.max():.3g} (limit {TP_F32_RTOL[1]:g})")
    want_m = refs["moe"]
    for rk in ranks:
        r = rel(rk["moe_losses"], want_m)
        if (r > lim).any():
            raise AssertionError(f"[pp] Qwen2-MoE pipe: losses "
                                 f"{rk['moe_losses']} against {want_m}")
    log(f"[pp] tiny Qwen2-MoE pipe (dropless, aux 0), pp 2, 1F1B: losses "
        f"{', '.join(f'{x:.7f}' for x in ranks[0]['moe_losses'])} against "
        f"the unpartitioned {', '.join(f'{x:.7f}' for x in want_m)}")
    want8 = refs["8b"]
    for rk in ranks:
        r = rel(rk["losses_8b"], want8)
        if (r > TP_BF16_RTOL).any():
            raise AssertionError(f"[pp] 8B width pp 2: losses "
                                 f"{rk['losses_8b']} against the "
                                 f"unpartitioned {want8} (limit "
                                 f"{TP_BF16_RTOL})")
    for rk in ranks:
        per = {n: c // PP_8B_STEPS for n, c in rk["launches_8b"].items()
               if c}
        log(f"[pp] {CARD}: Llama-3-8B width at {TP_8B_LAYERS} layers, "
            f"bf16, pp 2 stage {rk['stage']} "
            f"({rk['params_8b'] / 1e9:.3f} B parameters), 1F1B, ids "
            f"{list(PP_8B_IDS)} as {PP_8B_IDS[0]} microbatches, fused "
            f"carry, core_attn recompute: losses "
            f"{', '.join(f'{x:.6f}' for x in rk['losses_8b'])} against the "
            f"unpartitioned {', '.join(f'{x:.6f}' for x in want8)} (limit "
            f"{TP_BF16_RTOL:g}); ms a step "
            f"{', '.join(f'{x:.1f}' for x in rk['ms_8b'])}, peak "
            f"{rk['peak_gb_8b']:.2f} GB; launches a step {per}; built in "
            f"{rk['build_8b_s']:.1f} s; the rank's pp cases in "
            f"{rk['s']:.1f} s (f32 {rk['f32_s']:.1f} s)")
    log(f"[pp] {CARD}: the unpartitioned 8B width, one process: ms a step "
        f"{', '.join(f'{x:.1f}' for x in refs['8b_ms'])}, peak "
        f"{refs['8b_peak_gb']:.2f} GB; the references in {refs['s']:.1f} s")
    launches = {n: sum(rk["launches"][n] for rk in ranks)
                for n in ranks[0]["launches"]}
    needed = [n for n in TRAIN_KERNELS + MOE_KERNELS
              if n not in ("chunk_stats", "chunk_dlogits")]
    missing = [n for n in needed if not launches[n]]
    if missing:
        raise AssertionError(f"[pp] kernels not launched on the pp path: "
                             f"{missing}")
    return launches


# ---- phase tp, context parallelism (sep) ------------------------------------

SEP_IMPLS = ("ring", "ulysses", "allgather")
SEP_SGD_LR = 0.1                 # SGD shows a mis-scaled sep gradient
SEP_8B_LAYERS = 2                # Llama-3-8B's width at 2 of its 32 layers
SEP_8B_IDS = (1, 4096)           # 2048 tokens a rank at sep 2
# the kernels of the sep path: the unfused stack (K1/K2, K5/K6, no K3/K4),
# Ulysses' local attention (K7-K9) and the fused linear+CE (K10/K11)
SEP_KERNELS = ("rms_norm", "rms_norm_dx", "swiglu", "swiglu_bwd",
               "flash_attention_fwd", "flash_attention_dkv",
               "flash_attention_dq", "chunk_stats", "chunk_dlogits")


def _sep_fleet():
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(sep_degree=2, dp_degree=1)
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _sep_train(model, opt, batches, group=None, times=None, probe=None):
    """A step on each global batch, this rank on its sep rank's slice of
    the sequence (all of it without ``group``), then with ``probe`` a
    forward alone on that batch (its loss reads the steps' gradients):
    the losses, the probe's last (and ms a step into ``times``)."""
    import torch
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        split_inputs_sequence_dim

    def local(ids):
        t = torch.from_numpy(ids)
        if group is not None:
            t = split_inputs_sequence_dim(t, rank=group.rank, degree=2)
        return t.cuda()

    losses = []
    for ids in batches:
        t = local(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = model(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    if probe is not None:
        t = local(probe)
        with torch.no_grad():
            losses.append(model(t, labels=t)[1].item())
    return losses


def _sep_8b_config(cfg):
    import dataclasses
    return dataclasses.replace(cfg, num_hidden_layers=SEP_8B_LAYERS)


def _sep_references(cfg1b, cfg):
    """The unpartitioned runs the sep ranks are held to, beside phase tp's
    AdamW run of the f32 Llama (``_tp_configs``' depth 1): that Llama with
    SGD at ``SEP_SGD_LR``, and a step of the 8B width at
    ``SEP_8B_LAYERS`` layers in bf16 with the fused linear+CE and SGD on
    ``SEP_8B_IDS`` (its ms and peak)."""
    import torch
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.optimizer import SGD
    t0 = time.perf_counter()
    llama = _tp_configs(cfg1b)["llama"]
    out = {}
    model = _tp_model("llama", llama, torch.float32)
    opt = SGD(learning_rate=SEP_SGD_LR, parameters=model.parameters())
    out["sgd"] = _sep_train(model, opt, _tp_batches(llama, TP_BATCH, 30)[
        :TP_STEPS])
    del model, opt
    flags.set_flags({"FLAGS_fused_linear_cross_entropy": True})
    try:
        model = _tp_model("llama", _sep_8b_config(cfg), torch.bfloat16,
                          seed=0)
        opt = SGD(learning_rate=SEP_SGD_LR, parameters=model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        b8 = _tp_batches(model.config, SEP_8B_IDS, 0)
        out["8b"] = _sep_train(model, opt, b8[:1], times=times,
                               probe=b8[1])
        out["8b_ms"], out["8b_peak_gb"] = times[0], \
            torch.cuda.max_memory_allocated() / 1e9
        out["8b_params"] = sum(p.numel() for p in model.parameters())
        del model, opt
    finally:
        flags.set_flags({"FLAGS_fused_linear_cross_entropy": False})
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def _sep_runs(cfg, dtype, seed, cases, group, batches, wrappers,
              probe=None):
    """One model of ``cfg`` (built and broadcast over the data x sep ranks
    once), then for each ``(name, impl, make_optimizer)`` of ``cases``:
    the initial weights restored (from a host copy), ``sep_parallel`` set
    to ``impl`` (the layers read it at each forward), a fresh optimizer,
    a step on each batch and, with ``probe``, a forward alone on it.
    Returns {name: losses (the probe's last), ms, peak GB, the steps'
    launches}."""
    import dataclasses

    import torch
    from paddle_tpu_torch.distributed import fleet
    model = _tp_model("llama", dataclasses.replace(
        cfg, sep_parallel=cases[0][1]), dtype, seed=seed)
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    net = fleet.distributed_model(model)
    out = {}
    for name, impl, make in cases:
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(init[k])
        model.config.sep_parallel = impl
        opt = fleet.distributed_optimizer(make(model.parameters()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {n: w.launches for n, w in wrappers.items()}
        times = []
        losses = _sep_train(net, opt, batches, group, times)
        out[name] = {"losses": losses, "ms": times,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": {n: w.launches - before[n]
                                  for n, w in wrappers.items()}}
        if probe is not None:
            losses += _sep_train(net, opt, [], group, probe=probe)
        del opt
    del net, model, init
    torch.cuda.empty_cache()
    return out


def _sep_zigzag_check(llama, group):
    """The ring at the zigzag placement at the f32 Llama's attention
    shape ([2, 256] tokens, its heads): q, k, v from a seed, reordered,
    this rank's slice through ``ring_flash_attention(placement=
    "zigzag")``, gathered and restored, against full attention on the
    whole sequence (the model path is contiguous, as in the JAX
    package). Returns the max abs error."""
    import torch
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        gather_outputs_sequence_dim, ring_flash_attention,
        split_inputs_sequence_dim)
    from paddle_tpu_torch.ops.ring_attention import chunked_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s = TP_BATCH
    q, k, v = (torch.randn(b, s, h, llama.head_dim, device="cuda",
                           generator=gen)
               for h in (llama.num_attention_heads,
                         llama.num_key_value_heads,
                         llama.num_key_value_heads))
    local = split_inputs_sequence_dim([q, k, v], rank=group.rank, degree=2,
                                      zigzag=True)
    out = gather_outputs_sequence_dim(ring_flash_attention(
        *local, causal=True, placement="zigzag"), zigzag=True)
    ref = chunked_attention(q, k, v, causal=True, chunk=s)
    err = (out - ref).abs().max().item()
    if not err <= 2e-5:
        raise AssertionError(f"[sep] the zigzag ring: max abs err {err} "
                             f"against full attention (limit 2e-5)")
    return err


def sep_rank(out_dir, cfg1b, cfg):
    """The sep cases on one rank of phase tp, after its pp cases, with
    every kernel count at 0 first: a third ``fleet.init`` (sep 2), the f32
    Llama of the mp cases (``_tp_configs``) under each implementation
    through ``TP_STEPS`` AdamW steps and Ulysses with SGD, the zigzag ring
    at its attention shape, then a step of the 8B width in bf16 under each
    implementation (the fused linear+CE, SGD) and a forward alone on the
    next batch, counting each step's launches; rank 0 then holds K7-K9 at Ulysses' local shape. Returns
    the losses, ms a step, peak memory and launches."""
    import torch
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.optimizer import SGD, AdamW
    t0 = time.perf_counter()
    wrappers = _counted(TRAIN_KERNELS)
    group = _sep_fleet().get_sep_parallel_group()
    llama = _tp_configs(cfg1b)["llama"]

    def adamw(params):
        return AdamW(learning_rate=1e-3, parameters=params,
                     weight_decay=0.01)

    def sgd(params):
        return SGD(learning_rate=SEP_SGD_LR, parameters=params)

    out = {"rank": group.rank, "f32": _sep_runs(
        llama, torch.float32, 7,
        [(impl, impl, adamw) for impl in SEP_IMPLS]
        + [("ulysses sgd", "ulysses", sgd)], group,
        _tp_batches(llama, TP_BATCH, 30)[:TP_STEPS], wrappers)}
    out["zigzag_err"] = _sep_zigzag_check(llama, group)
    out["f32_s"] = time.perf_counter() - t0
    cfg8 = _sep_8b_config(cfg)
    flags.set_flags({"FLAGS_fused_linear_cross_entropy": True})
    try:
        b8 = _tp_batches(cfg8, SEP_8B_IDS, 0)
        out["8b"] = _sep_runs(
            cfg8, torch.bfloat16, 0, [(i, i, sgd) for i in SEP_IMPLS], group,
            b8[:1], wrappers, probe=b8[1])
    finally:
        flags.set_flags({"FLAGS_fused_linear_cross_entropy": False})
    out["launches"] = {n: w.launches for n, w in wrappers.items()}
    if group.rank == 0:
        gen = torch.Generator(device="cuda").manual_seed(98)

        def rand(*shape, dtype=torch.bfloat16):
            return torch.randn(*shape, device="cuda",
                               generator=gen).to(dtype)

        nh = cfg8.num_attention_heads // 2
        flash = flash_checks(1, SEP_8B_IDS[1], nh, nh, cfg8.head_dim, rand)
        out["kernels"] = {
            k: {"max_abs_err": v["max_abs_err"],
                "shape": f"q, kv [1,{SEP_8B_IDS[1]},{nh},{cfg8.head_dim}] "
                         "(Ulysses at sep 2, kv heads repeated)"}
            for k, v in flash.items()}
    out["s"] = time.perf_counter() - t0
    return out


def _sep_check(ranks, refs, tp_refs):
    """The sep cases of both ranks against the unpartitioned runs (phase
    tp's f32 Llama and ``_sep_references``), logged beside the card's
    name and power limit; returns the launches of the sep path summed
    over the ranks (K1/K2, K5-K11 must be there, K3/K4 not: the unfused
    stack; Ulysses' step launches K7, K8 and K9 once a layer)."""
    def rel(got, want):
        return np.abs(np.asarray(got) - np.asarray(want)) / \
            np.abs(np.asarray(want))

    lim = np.array([TP_F32_RTOL[0]] + [TP_F32_RTOL[1]] * (TP_STEPS - 1))
    for impl in SEP_IMPLS + ("ulysses sgd",):
        want = refs["sgd"] if "sgd" in impl else tp_refs["llama"][:TP_STEPS]
        got = [rk["f32"][impl]["losses"] for rk in ranks]
        if any((rel(g, want) > lim).any() for g in got):
            raise AssertionError(f"[sep] {impl}: the ranks' losses {got} "
                                 f"against the unpartitioned {want}")
        log(f"[sep] Llama-1B width at depth 1, f32, sep 2, {impl}"
            f"{' (lr ' + str(SEP_SGD_LR) + ')' if 'sgd' in impl else ''}, "
            f"{list(TP_BATCH)} as {TP_BATCH[1] // 2} tokens a rank: losses "
            f"{', '.join(f'{x:.7f}' for x in got[0])} against the "
            f"unpartitioned {', '.join(f'{x:.7f}' for x in want)}: worst "
            f"relative {max(rel(g, want).max() for g in got):.3g} (limits "
            f"{TP_F32_RTOL[0]:g} first, {TP_F32_RTOL[1]:g} after); ms a step "
            f"{', '.join(f'{x:.1f}' for x in ranks[0]['f32'][impl]['ms'])}")
    log(f"[sep] the ring at the zigzag placement, q {list(TP_BATCH)} "
        f"tokens at Llama-1B's heads, f32: max abs err "
        f"{max(rk['zigzag_err'] for rk in ranks):.3g} against full "
        f"attention (limit 2e-5)")
    want8 = refs["8b"]
    flash = ("flash_attention_fwd", "flash_attention_dkv",
             "flash_attention_dq")
    for impl in SEP_IMPLS:
        want_flash = SEP_8B_LAYERS if impl == "ulysses" else 0
        for rk in ranks:
            case = rk["8b"][impl]
            # the step's loss, then the next batch's after the step: the
            # backward of the attention, the loss's sum over sep and the
            # data x sep gradient average all reach the second
            r = float(rel(case["losses"], want8).max()) if len(
                case["losses"]) == len(want8) == 2 else float("inf")
            if not r <= TP_BF16_RTOL:
                raise AssertionError(
                    f"[sep] 8B width {impl}: rank {rk['rank']}'s losses "
                    f"{case['losses']} (the step's, then the next batch's "
                    f"after it) against the unpartitioned {want8} (limit "
                    f"{TP_BF16_RTOL})")
            per = {n: c for n, c in case["launches"].items() if c}
            if any(case["launches"][n] != want_flash for n in flash) or \
                    case["launches"]["rms_norm_residual"] or \
                    case["launches"]["rms_norm_residual_dh"]:
                raise AssertionError(
                    f"[sep] 8B width {impl}: launches in the step {per}: "
                    f"K7/K8/K9 {want_flash} each (Ulysses' local "
                    f"attention, one a layer), K3/K4 none")
            log(f"[sep] {CARD}: Llama-3-8B width at {SEP_8B_LAYERS} "
                f"layers, bf16, sep 2 rank {rk['rank']}, {impl}, ids "
                f"{list(SEP_8B_IDS)} as {SEP_8B_IDS[1] // 2} tokens a rank, "
                f"fused linear+CE, SGD: the step's loss "
                f"{case['losses'][0]:.6f} and the next batch's after it "
                f"{case['losses'][1]:.6f} against the unpartitioned "
                f"{want8[0]:.6f}, {want8[1]:.6f} (worst relative {r:.3g}, "
                f"limit {TP_BF16_RTOL:g}); the step "
                f"{case['ms'][0]:.1f} ms, peak {case['peak_gb']:.2f} GB; "
                f"launches in the step {per}")
    log(f"[sep] {CARD}: the unpartitioned 8B width ("
        f"{refs['8b_params'] / 1e9:.3f} B parameters), one process: the "
        f"step {refs['8b_ms']:.1f} ms, peak {refs['8b_peak_gb']:.2f} GB; "
        f"the references in {refs['s']:.1f} s; the ranks' sep cases in "
        f"{', '.join(f'{rk['s']:.1f}' for rk in ranks)} s (f32 "
        f"{', '.join(f'{rk['f32_s']:.1f}' for rk in ranks)} s)")
    launches = {n: sum(rk["launches"][n] for rk in ranks)
                for n in ranks[0]["launches"]}
    missing = [n for n in SEP_KERNELS if not launches[n]]
    if missing:
        raise AssertionError(f"[sep] kernels not launched on the sep path: "
                             f"{missing}")
    return launches


# ---- phase tp, expert parallelism (ep) ------------------------------------

EP_CF = 4.0                      # E / k of the f32 cases: no token drops
EP_DROP_CF = 2.0                 # Qwen2MoeConfig's own: tokens drop
EP_DROP_STEPS = 2                # AdamW steps of the drop case, card and CPU
EP_WIDE_LAYERS = 2               # qwen2_moe_a14b's width at 2 of 28 layers
EP_WIDE_IDS = (1, 2048)          # one sequence, 1024 tokens a rank at ep 2
EP_WIDE_CF = 15.0                # 60 experts / top-4: no token drops
# the kernels of the ep path: K1/K2, the fused carry K3/K4, the shared
# expert's K5/K6 and the attention's K7-K9 (Qwen2-MoE's loss is the plain
# shifted CE: no K10/K11); the experts' FFN is torch.bmm (XLA einsums in
# the JAX package's moe_ffn_grouped, no Pallas kernel)
EP_KERNELS = tuple(n for n in TRAIN_KERNELS
                   if n not in ("chunk_stats", "chunk_dlogits"))


def _ep_configs():
    """The f32 cases' configs: Qwen2-MoE at a narrow width (1024 wide, 16
    heads of 64, 4 kv heads, 8 experts top-2 of width 512, a shared
    expert of 2048, depth 2) and the tiny DeepSeek-V2, the aux loss
    folded out (each rank's aux is over its own tokens) and a capacity
    factor of E/k."""
    import dataclasses

    from paddle_tpu_torch.models import DeepseekV2Config, Qwen2MoeConfig
    narrow = dataclasses.replace(
        Qwen2MoeConfig.tiny(), vocab_size=32000, hidden_size=1024,
        num_attention_heads=16, num_key_value_heads=4,
        moe_intermediate_size=512, shared_expert_intermediate_size=2048,
        max_position_embeddings=512, rope_theta=1000000.0,
        capacity_factor=EP_CF, router_aux_loss_coef=0.0)
    deepseek = dataclasses.replace(DeepseekV2Config.tiny(),
                                   router_aux_loss_coef=0.0)
    return {"qwen2_moe": narrow, "deepseek": deepseek}


def _ep_wide_config():
    import dataclasses

    from paddle_tpu_torch.models import Qwen2MoeConfig
    return dataclasses.replace(Qwen2MoeConfig.qwen2_moe_a14b(),
                               num_hidden_layers=EP_WIDE_LAYERS,
                               capacity_factor=EP_WIDE_CF)


def _ep_model(family, cfg, dtype, seed, device="cuda"):
    """``_tp_model``'s model with every MoE layer at the config's
    capacity factor (DeepSeek's config has no field: E/k)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import (DeepseekV2ForCausalLM,
                                         Qwen2MoeForCausalLM)
    cls = {"qwen2_moe": Qwen2MoeForCausalLM,
           "deepseek": DeepseekV2ForCausalLM}[family]
    model = cls(cfg, device=device, dtype=dtype, seed=seed)
    for m in model.modules():
        if isinstance(m, MoELayer):
            m.gate.capacity_factor = getattr(cfg, "capacity_factor", EP_CF)
    return model


def _ep_batches(family, cfg):
    return _tp_batches(cfg, TP_BATCH if family == "qwen2_moe"
                       else TP_TINY_BATCH, 50)


def _ep_fleet():
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(ep_degree=2, dp_degree=1)
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _ep_cases(model, family, cfg, make_opt, sgd, steps, times=None,
              save=None):
    """From the model's weights as built: ``steps`` AdamW steps (with
    ``save``, its checkpoint then), then from the same weights again one
    SGD step at ``SEP_SGD_LR`` and the next batch's loss after it.
    Returns {"adamw": losses, "sgd": [the step's, the probe's]}."""
    import torch
    from paddle_tpu_torch.hapi import Model
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    batches = _ep_batches(family, cfg)
    opt = make_opt(model.parameters())
    out = {"adamw": _sep_train(model, opt, batches[:steps], times=times)}
    if save is not None:
        m = Model(model)
        m.prepare(opt)
        m.save_checkpoint(save, epoch=0)
        del m
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(init[k])
    opt = sgd(model.parameters())
    out["sgd"] = _sep_train(model, opt, batches[:1], probe=batches[1])
    return out


def _ep_adamw(params):
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=1e-3, parameters=params, weight_decay=0.01)


def _ep_sgd(params):
    from paddle_tpu_torch.optimizer import SGD
    return SGD(learning_rate=SEP_SGD_LR, parameters=params)


def _ep_references():
    """The unpartitioned runs the ep ranks are held to: each f32 case
    through ``_ep_cases`` (its AdamW run on to ``TP_STEPS + TP_RESUMED``
    steps, which the ep 2 checkpoint's resume is held to), and the full
    width in bf16: one SGD step and the next batch's loss after it (its
    ms and peak, the banks' bytes)."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for family, cfg in _ep_configs().items():
        model = _ep_model(family, cfg, torch.float32, 7)
        out[family] = _ep_cases(model, family, cfg, _ep_adamw, _ep_sgd,
                                TP_STEPS + TP_RESUMED)
        del model
    torch.cuda.empty_cache()
    model = _ep_model("qwen2_moe", _ep_wide_config(), torch.bfloat16, 0)
    opt = _ep_sgd(model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    b = _tp_batches(model.config, EP_WIDE_IDS, 0)
    out["wide"] = _sep_train(model, opt, b[:1], times=times, probe=b[1])
    out["wide_ms"] = times[0]
    out["wide_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["wide_params"] = sum(p.numel() for p in model.parameters())
    out["wide_bank_gb"] = _ep_bank_bytes(model) / 1e9
    del model, opt
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def _ep_bank_bytes(model):
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    return sum(p.numel() * p.element_size() for m in model.modules()
               if isinstance(m, MoELayer) for p in m._banks())


class _EpRouting:
    """Records each MoE forward's kept assignments (``keep`` of the
    routing) and, when ``timed``, the bytes a rank hands to the
    all-to-alls and their seconds on the host clock (each call
    synchronised on both sides), while installed."""

    def __init__(self, timed=False):
        self.keeps, self.a2a_bytes, self.a2a_s, self.a2a_calls = [], 0, 0.0, 0
        self.timed = timed

    def __enter__(self):
        from paddle_tpu_torch.distributed import parallel_layers as pl
        from paddle_tpu_torch.ops import moe as moe_ops
        self._gating, self._a2a = moe_ops.top_k_gating_idx, pl._all_to_all

        def gating(*a, **kw):
            res = self._gating(*a, **kw)
            self.keeps.append(res[3].detach().cpu())
            return res

        def a2a(x, *a):
            import torch
            if self.timed and x.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._a2a(x, *a)
            if self.timed and x.is_cuda:
                torch.cuda.synchronize()
            self.a2a_s += time.perf_counter() - t0
            self.a2a_bytes += x.numel() * x.element_size()
            self.a2a_calls += 1
            return out

        moe_ops.top_k_gating_idx, pl._all_to_all = gating, a2a
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed import parallel_layers as pl
        from paddle_tpu_torch.ops import moe as moe_ops
        moe_ops.top_k_gating_idx, pl._all_to_all = self._gating, self._a2a


def _ep_drop_case(cfg):
    """The narrow Qwen2-MoE at its config's own capacity factor (2.0:
    tokens drop) and aux loss (0.001), ``EP_DROP_STEPS`` AdamW steps at ep
    2 on the card, then the same steps from the same weights on CPU
    tensors (the kernels' plain versions, gloo on host memory): the
    losses of both and whether every forward kept the same assignments,
    with the count it dropped."""
    import dataclasses

    import torch
    cfg = dataclasses.replace(cfg, capacity_factor=EP_DROP_CF,
                              router_aux_loss_coef=0.001)
    batches = _ep_batches("qwen2_moe", cfg)[:EP_DROP_STEPS]
    model = _ep_model("qwen2_moe", cfg, torch.float32, 7)
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    with _EpRouting() as card:
        losses = _sep_train(model, _ep_adamw(model.parameters()), batches)
    del model
    torch.cuda.empty_cache()
    model = _ep_model("qwen2_moe", cfg, torch.float32, 7, device="cpu")
    model.load_state_dict(init)
    cpu_losses = []
    with _EpRouting() as cpu:
        opt = _ep_adamw(model.parameters())
        for ids in batches:
            t = torch.from_numpy(ids)
            _, loss = model(t, labels=t)
            loss.backward()
            opt.step()
            opt.clear_grad()
            cpu_losses.append(loss.item())
    same = len(card.keeps) == len(cpu.keeps) and all(
        torch.equal(a, b) for a, b in zip(card.keeps, cpu.keeps))
    return {"losses": losses, "cpu_losses": cpu_losses, "same_keep": same,
            "forwards": len(card.keeps),
            "dropped": int(sum((~k).sum() for k in card.keeps)),
            "assignments": int(sum(k.numel() for k in card.keeps))}


def ep_rank(out_dir):
    """The ep cases on one rank of phase tp, after its sep cases, with
    every kernel count at 0 first: a fourth ``fleet.init`` (ep 2), each
    f32 case of ``_ep_configs`` through ``_ep_cases`` (the Qwen2-MoE's
    AdamW run saved into ``out_dir/ep_ck``), the drop case, then the full
    width in bf16 through one SGD step and the next batch's forward.
    Returns the losses, ms a step, peak memory, bank shapes, the
    all-to-alls' bytes and seconds and the launches."""
    import torch
    from paddle_tpu_torch.distributed import fleet
    t0 = time.perf_counter()
    wrappers = _counted(TRAIN_KERNELS)
    group = _ep_fleet().get_expert_parallel_group()
    out = {"rank": group.rank, "f32": {}}
    for family, cfg in _ep_configs().items():
        model = _ep_model(family, cfg, torch.float32, 7)
        net = fleet.distributed_model(model)
        times = []
        case = out["f32"][family] = _ep_cases(
            net, family, cfg,
            lambda ps: fleet.distributed_optimizer(_ep_adamw(ps)),
            lambda ps: fleet.distributed_optimizer(_ep_sgd(ps)), TP_STEPS,
            times, os.path.join(out_dir, "ep_ck") if family == "qwen2_moe"
            else None)
        case["ms"] = times
        case["banks"] = sorted({tuple(p.shape) for n, p in
                                model.named_parameters()
                                if n.endswith(("w_gate", "w_up", "w_down"))})
        del net, model
    out["drop"] = _ep_drop_case(_ep_configs()["qwen2_moe"])
    torch.cuda.empty_cache()
    out["f32_s"] = time.perf_counter() - t0
    model = _ep_model("qwen2_moe", _ep_wide_config(), torch.bfloat16, 0)
    opt = fleet.distributed_optimizer(_ep_sgd(model.parameters()))
    out["wide_params"] = sum(p.numel() for p in model.parameters())
    out["wide_bank_gb"] = _ep_bank_bytes(model) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: w.launches for n, w in wrappers.items()}
    times = []
    b = _tp_batches(model.config, EP_WIDE_IDS, 0)
    with _EpRouting(timed=True) as route:
        out["wide"] = _sep_train(model, opt, b[:1], times=times)
        step = (route.a2a_bytes, route.a2a_s, route.a2a_calls)
        out["wide"] += _sep_train(model, opt, [], probe=b[1])
    out["wide_launches"] = {n: w.launches - before[n]
                            for n, w in wrappers.items()}
    out["wide_ms"] = times[0]
    out["wide_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["wide_a2a"] = {"bytes": step[0], "s": step[1], "calls": step[2]}
    out["wide_dropped"] = int(sum((~k).sum() for k in route.keeps))
    del model, opt
    torch.cuda.empty_cache()
    out["launches"] = {n: w.launches for n, w in wrappers.items()}
    fleet.fleet._reset()
    out["s"] = time.perf_counter() - t0
    return out


def _ep_resume(out_dir):
    """The narrow Qwen2-MoE's ep 2 checkpoint loaded into the
    unpartitioned model (f32, another seed) through
    ``hapi.Model.load_checkpoint``, then ``TP_RESUMED`` AdamW steps:
    (losses, the optimizer's step count)."""
    import torch
    from paddle_tpu_torch.hapi import Model
    cfg = _ep_configs()["qwen2_moe"]
    model = _ep_model("qwen2_moe", cfg, torch.float32, 11)
    opt = _ep_adamw(model.parameters())
    m = Model(model)
    m.prepare(opt)
    m.load_checkpoint(os.path.join(out_dir, "ep_ck"))
    step0 = opt._step_count
    losses = _sep_train(model, opt, _ep_batches("qwen2_moe", cfg)[
        TP_STEPS:])
    del m, model, opt
    torch.cuda.empty_cache()
    return losses, step0


def _ep_check(ranks, refs, resumed):
    """The ep cases of both ranks against the unpartitioned runs (and the
    drop case against the ranks' CPU run), logged beside the card's name
    and power limit; returns the launches of the ep path summed over the
    ranks (K1-K9 must be there)."""
    def rel(got, want):
        return np.abs(np.asarray(got) - np.asarray(want)) / \
            np.abs(np.asarray(want))

    lim = np.array([TP_F32_RTOL[0]] + [TP_F32_RTOL[1]] * (TP_STEPS - 1))
    for family in _ep_configs():
        want = refs[family]
        for rk in ranks:
            case = rk["f32"][family]
            got, sgd = case["adamw"], case["sgd"]
            r = rel(got, want["adamw"][:TP_STEPS])
            r_sgd = rel(sgd, want["sgd"])
            if (r > lim).any() or (r_sgd > TP_F32_RTOL[0]).any():
                raise AssertionError(
                    f"[ep] {family} f32 ep 2 rank {rk['rank']}: AdamW losses "
                    f"{got}, SGD {sgd} against the unpartitioned "
                    f"{want['adamw'][:TP_STEPS]}, {want['sgd']}")
            banks = case["banks"]
            if any(b[0] != 4 for b in banks):
                raise AssertionError(f"[ep] {family}: rank {rk['rank']} "
                                     f"holds banks {banks}, not 4 of 8 "
                                     "experts")
        r0 = ranks[0]["f32"][family]
        worst = max(rel(rk["f32"][family]["adamw"],
                        want["adamw"][:TP_STEPS]).max() for rk in ranks)
        worst_sgd = max(rel(rk["f32"][family]["sgd"], want["sgd"]).max()
                        for rk in ranks)
        log(f"[ep] {family} f32 ep 2 (cf {EP_CF:g}, no drop): AdamW losses "
            f"{', '.join(f'{x:.7f}' for x in r0['adamw'])} against the "
            f"unpartitioned "
            f"{', '.join(f'{x:.7f}' for x in want['adamw'][:TP_STEPS])} "
            f"(worst relative {worst:.3g}, limits {TP_F32_RTOL[0]:g} first, "
            f"{TP_F32_RTOL[1]:g} after); SGD lr {SEP_SGD_LR}: the step's and "
            f"the next batch's {', '.join(f'{x:.7f}' for x in r0['sgd'])} "
            f"against {', '.join(f'{x:.7f}' for x in want['sgd'])} (worst "
            f"relative {worst_sgd:.3g}, limit {TP_F32_RTOL[0]:g}); banks a "
            f"rank {r0['banks']}; ms a step "
            f"{', '.join(f'{x:.1f}' for x in r0['ms'])}")
    losses, step0 = resumed
    want = refs["qwen2_moe"]["adamw"][TP_STEPS:]
    r = rel(losses, want)
    if step0 != TP_STEPS or (r > TP_F32_RTOL[1]).any():
        raise AssertionError(f"[ep] the ep 2 checkpoint resumed at ep 1: "
                             f"step {step0}, losses {losses} against the "
                             f"unpartitioned run's {want}")
    log(f"[ep] the narrow Qwen2-MoE's ep 2 checkpoint (after {TP_STEPS} "
        f"steps) resumed unpartitioned at step {step0}: losses "
        f"{', '.join(f'{x:.7f}' for x in losses)} against the unpartitioned "
        f"run's {', '.join(f'{x:.7f}' for x in want)} (worst relative "
        f"{r.max():.3g}, limit {TP_F32_RTOL[1]:g})")
    for rk in ranks:
        d = rk["drop"]
        r = rel(d["losses"], d["cpu_losses"])
        if not d["same_keep"] or not d["dropped"] or \
                (r > TP_F32_RTOL[1]).any():
            raise AssertionError(
                f"[ep] drop case rank {rk['rank']}: same kept slots "
                f"{d['same_keep']}, {d['dropped']} dropped, losses "
                f"{d['losses']} against the CPU run's {d['cpu_losses']}")
        log(f"[ep] narrow Qwen2-MoE at cf {EP_DROP_CF:g} (aux 0.001), ep 2 "
            f"rank {rk['rank']}: {d['dropped']} of {d['assignments']} "
            f"assignments dropped over {d['forwards']} forwards, the same "
            f"kept slots as the ranks' run on CPU tensors; losses "
            f"{', '.join(f'{x:.7f}' for x in d['losses'])} against the "
            f"CPU's {', '.join(f'{x:.7f}' for x in d['cpu_losses'])} (worst "
            f"relative {r.max():.3g}, limit {TP_F32_RTOL[1]:g})")
    want = refs["wide"]
    for rk in ranks:
        r = rel(rk["wide"], want)
        if len(rk["wide"]) != 2 or not (r <= TP_BF16_RTOL).all() or \
                rk["wide_dropped"]:
            raise AssertionError(
                f"[ep] full width rank {rk['rank']}: losses {rk['wide']} "
                f"(the step's, then the next batch's after it) against the "
                f"unpartitioned {want} (limit {TP_BF16_RTOL}), "
                f"{rk['wide_dropped']} dropped")
        a2a = rk["wide_a2a"]
        per = {n: c for n, c in rk["wide_launches"].items() if c}
        log(f"[ep] {CARD}: qwen2_moe_a14b width at {EP_WIDE_LAYERS} layers "
            f"({rk['wide_params'] / 1e9:.3f} B parameters a rank, the banks "
            f"{rk['wide_bank_gb']:.3f} GB against "
            f"{refs['wide_bank_gb']:.3f} unpartitioned), bf16, ep 2 rank "
            f"{rk['rank']}, ids {list(EP_WIDE_IDS)} as "
            f"{EP_WIDE_IDS[1] // 2} tokens a rank, cf {EP_WIDE_CF:g}, SGD: "
            f"the step's loss {rk['wide'][0]:.6f} and "
            f"the next batch's after it {rk['wide'][1]:.6f} against the "
            f"unpartitioned {want[0]:.6f}, {want[1]:.6f} (worst relative "
            f"{r.max():.3g}, limit {TP_BF16_RTOL:g}); the step "
            f"{rk['wide_ms']:.1f} ms, of it the {a2a['calls']} all-to-alls "
            f"{a2a['s'] * 1e3:.1f} ms ({a2a['bytes'] / 1e9:.3f} GB handed to "
            f"them), peak {rk['wide_peak_gb']:.2f} GB; launches in the step "
            f"and the forward after it {per}")
    log(f"[ep] {CARD}: the unpartitioned full width "
        f"({refs['wide_params'] / 1e9:.3f} B parameters), one process: the "
        f"step {refs['wide_ms']:.1f} ms, peak {refs['wide_peak_gb']:.2f} GB;"
        f" the references in {refs['s']:.1f} s; the ranks' ep cases in "
        f"{', '.join(f'{rk['s']:.1f}' for rk in ranks)} s (f32 "
        f"{', '.join(f'{rk['f32_s']:.1f}' for rk in ranks)} s)")
    launches = {n: sum(rk["launches"][n] for rk in ranks)
                for n in ranks[0]["launches"]}
    missing = [n for n in EP_KERNELS if not launches[n]]
    if missing:
        raise AssertionError(f"[ep] kernels not launched on the ep path: "
                             f"{missing}")
    return launches


def main():
    if sys.argv[1:2] == ["--preempt-worker"]:
        return preempt_worker(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import dataclasses

    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.models import LlamaConfig, Qwen2MoeConfig
    # unrolled stacks, as every section of the JAX bench sets them
    # (scan_layers=False): the fused carry and selective recompute
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), scan_layers=False)
    cfg1b = dataclasses.replace(LlamaConfig.llama_1b(), scan_layers=False)
    # the serving phases' Llama-3-8B at a quarter of its depth (8 of 32
    # layers) and the Llama-1B they serve (prefix to http) at 4 of 16 (8
    # until the sep cases came in): the script's time limit, which a slow
    # host nearly reaches at twice these depths
    cfg_serve = dataclasses.replace(cfg, num_hidden_layers=8)
    cfg1b_serve = dataclasses.replace(cfg1b, num_hidden_layers=4)
    t_start = time.perf_counter()

    def mark(tag):
        """Log the script's elapsed time after a phase (where it goes)."""
        log(f"[time] {tag} done at {time.perf_counter() - t_start:.1f} s")

    phase_setup()
    mark("setup")
    res = phase_kernels(cfg)
    res.update(phase_train_kernels(cfg))
    res.update(phase_fused_kernels(cfg))
    res.update(phase_moe_kernels(Qwen2MoeConfig.qwen2_moe_a14b()))
    res.update(phase_quant_kernels(cfg, Qwen2MoeConfig.qwen2_moe_a14b()))
    for name, entries in phase_2_4b_kernels().items():
        res[name].setdefault("models", {}).update(entries)
    mark("kernel checks")
    model = serve_model(cfg_serve)
    serve = phase_serve(cfg_serve, model)
    serve_quant = {m: phase_serve(cfg_serve, model, kv_quant=m)
                   for m in QUANT_MODES}
    for m, r in serve_quant.items():
        log(f"[serve_quant {m}] greedy top-1 agreement with the bf16 pools' "
            f"streams on the same weights: "
            f"{_agreement(r['streams'], serve['streams']):.4f} "
            f"({sum(a == b for a, b in zip(r['streams'], serve['streams']))}"
            f"/12 streams identical)")
    mark("serve, serve_quant")
    phase_quant_accuracy(model)
    phase_capacity(model)
    mark("quant_accuracy, capacity")
    phase_spec_8b(model, serve["streams"])
    gen8b = phase_generate_8b(model)
    legacy = phase_legacy(cfg_serve, model, serve)
    del model
    mark("spec_8b, generate 8b, legacy")
    weight_quant = phase_weight_quant(cfg_serve, serve["streams"])
    mark("weight_quant")
    model1b = serve_model_1b(cfg1b_serve)
    prefix = phase_prefix(model1b)
    overload = phase_overload(model1b)
    mark("prefix, overload")
    spec = phase_spec(model1b)
    decode_bench = phase_decode_bench(model1b)
    mark("spec, decode bench")
    fleet = phase_fleet(model1b)
    http = phase_http(model1b)
    del model1b
    mark("fleet, http")
    phase_fleet_parity(cfg1b)
    observability = phase_observability(cfg1b)
    mark("fleet_parity, observability")
    procfleet = phase_procfleet(cfg1b)
    mark("procfleet")
    phase_proc_parity(cfg1b)
    mark("proc_parity")
    disagg = phase_disagg(cfg1b)
    mark("disagg")
    autoscale = phase_autoscale(cfg1b)
    mark("autoscale")
    models = phase_parity(cfg)
    phase_parity(cfg, kv_quant="int8", models=models)
    del models
    torch.cuda.empty_cache()
    decode = phase_decode(cfg)
    mark("parity, decode")
    flags.set_flags({"FLAGS_fused_rmsnorm_residual": False})
    try:
        train = phase_train(cfg)
    finally:
        flags.set_flags({"FLAGS_fused_rmsnorm_residual": True})
    phase_train_parity(cfg1b)
    full = phase_train_full(cfg)
    train_2_4b = phase_train_2_4b()
    mark("train_full, train_2_4b")
    fit = phase_fit(cfg1b)
    phase_fused_parity(cfg1b)
    mark("training")
    train_loop = phase_train_loop(dataclasses.replace(cfg1b,
                                                      num_hidden_layers=1))
    mark("train_loop")
    preempt = phase_preempt(cfg1b)
    mark("preempt")
    a14b = Qwen2MoeConfig.qwen2_moe_a14b()
    serve_moe = phase_serve_moe(a14b)
    wide = phase_moe_train("moe_train_wide", dataclasses.replace(
        a14b, num_hidden_layers=4, moe_dropless=True, use_recompute=True,
        router_aux_loss_coef=0.0))
    moe_bench = phase_moe_train("moe_bench", moe_bench_config())
    phase_moe_parity(moe_bench_config())
    mark("moe")
    for name, entries in phase_model_kernels().items():
        res[name].setdefault("models", {}).update(entries)
    mark("model_kernels")
    gpt2 = phase_gpt2()
    mark("gpt2")
    ernie = phase_ernie()
    mark("ernie")
    deepseek = phase_deepseek()
    mark("deepseek")
    llama70 = phase_llama70()
    phase_model_parity()
    mark("llama70, model_parity")
    tp = phase_tp(cfg, cfg1b)
    for name, entry in tp["kernels"].items():
        kernel, _, sep = name.partition(" ")
        res[kernel].setdefault("models", {})[
            "llama3_8b_sep2_ulysses" if sep else "llama3_8b_mp2_shard"] = entry
    mark("tp")
    pallas = "paddle_tpu/ops/pallas/"
    gm_cu = "paddle_tpu_torch/csrc/grouped_matmul.cu"
    rms_cu = "paddle_tpu_torch/csrc/rms_norm.cu"
    ce_cu = "paddle_tpu_torch/csrc/ce_chunk.cu"
    fa_cu = "paddle_tpu_torch/csrc/flash_attention.cu"
    sources = {
        "rms_norm": (rms_cu, pallas + "rms_norm.py:38"),
        "rms_norm_dx": (rms_cu, pallas + "rms_norm.py:45"),
        "rms_norm_residual": (rms_cu, pallas + "rms_norm.py:206"),
        "rms_norm_residual_dh": (rms_cu, pallas + "rms_norm.py:218"),
        "swiglu": ("paddle_tpu_torch/csrc/swiglu.cu",
                   pallas + "swiglu.py:39"),
        "swiglu_bwd": ("paddle_tpu_torch/csrc/swiglu.cu",
                       pallas + "swiglu.py:45"),
        "flash_attention_fwd": (fa_cu, pallas + "flash_attention.py:104"),
        "flash_attention_dkv": (fa_cu, pallas + "flash_attention.py:226"),
        "flash_attention_dq": (fa_cu, pallas + "flash_attention.py:286"),
        "chunk_stats": (ce_cu, pallas + "ce_chunk.py:42"),
        "chunk_dlogits": (ce_cu, pallas + "ce_chunk.py:67"),
        "ragged_paged_attention": (
            "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            pallas + "ragged_paged_attention.py:120"),
        "grouped_matmul": (gm_cu, pallas + "grouped_matmul.py:65"),
        "grouped_matmul_t": (gm_cu, pallas + "grouped_matmul.py:65"),
        "grouped_dw": (gm_cu, pallas + "grouped_matmul.py:113"),
        "ragged_paged_attention_quant": (
            "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            pallas + "ragged_paged_attention.py:217"),
        "paged_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "jax/experimental/pallas/ops/tpu/paged_attention/"
            "paged_attention_kernel.py:113"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = res[name]
        # each path ran with the counts at 0 just before it: serving
        # (phase 3), quantized serving (int8 and fp8, 4), serving with
        # weight-only int8 and int4 (7), the prefix and overload storms
        # (8, 9), the spec A/B, self-speculative drafts and spec over
        # int8 pools (10), the decode entry point (13), unfused
        # training (14), the full training step (16), llama_2_4b's
        # preset step (16b), fit (17), the
        # train_gpt2 loop's 40 steps (27), the preemptible fit's two
        # rounds and its two uninterrupted runs (38), MoE
        # serving (20) and the two MoE training steps (21, 22), generate
        # (25: the decode bench, the 8B runs and the MoE run), the
        # legacy engine (26, bf16 and int8 pools), GPT-2's training,
        # generate and engine runs (29), ERNIE's pretraining and
        # classification steps (30), DeepSeek-V2's generate, training
        # step and MLA decode bench (31), Llama-3-70B's serving (32), the
        # fleet's timed run (34), the HTTP legs (35), the
        # observability fleet's runs (37), the surviving workers of the
        # process-backed fleet (39), the disaggregated and colocated
        # workers with the f32/int8 in-process fleets (41), the
        # autoscaled fleet (42), both ranks of the mp 2 Llama-3-8B
        # steps (43), both ranks' pp cases (43, pp), both ranks' sep
        # cases (43, sep: the f32 Llama and the 8B width) and both ranks'
        # ep cases (43, ep: the f32 Qwen2-MoE and DeepSeek-V2, the drop
        # case and qwen2_moe_a14b's width); launches is their sum
        counts = {"serve": serve["launches"].get(name, 0),
                  "serve_quant": sum(sq["launches"].get(name, 0)
                                     for sq in serve_quant.values()),
                  "weight_quant": weight_quant["launches"].get(name, 0),
                  "prefix": prefix["launches"].get(name, 0),
                  "overload": overload["launches"].get(name, 0),
                  "spec": spec["launches"].get(name, 0),
                  "spec_self": spec["launches_self"].get(name, 0),
                  "spec_int8": spec["launches_int8"].get(name, 0),
                  "decode": decode["launches"].get(name, 0),
                  "train": train["launches"].get(name, 0),
                  "train_full": full["launches"].get(name, 0),
                  "train_2_4b": train_2_4b["launches"].get(name, 0),
                  "fit": fit["launches"].get(name, 0),
                  "train_loop": train_loop["launches"].get(name, 0),
                  "preempt": preempt["launches"].get(name, 0),
                  "serve_moe": serve_moe["launches"].get(name, 0),
                  "moe_train_wide": wide["launches"].get(name, 0),
                  "moe_bench": moe_bench["launches"].get(name, 0),
                  "generate": sum(g["launches"].get(name, 0) for g in (
                      decode_bench, gen8b, serve_moe["generate"])),
                  "legacy": legacy["launches"].get(name, 0),
                  "gpt2": gpt2["launches"].get(name, 0),
                  "ernie": ernie["launches"].get(name, 0),
                  "deepseek": deepseek["launches"].get(name, 0),
                  "llama70": llama70["launches"].get(name, 0),
                  "fleet": fleet["launches"].get(name, 0),
                  "http": http["launches"].get(name, 0),
                  "observability": observability["launches"].get(name, 0),
                  "procfleet": procfleet["launches"].get(name, 0),
                  "disagg": disagg["launches"].get(name, 0),
                  "autoscale": autoscale["launches"].get(name, 0),
                  "tp": tp["launches"].get(name, 0),
                  "pp": tp["launches_pp"].get(name, 0),
                  "sep": tp["launches_sep"].get(name, 0),
                  "ep": tp["launches_ep"].get(name, 0)}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(counts.values()),
                        **{f"launches_{k}": v for k, v in counts.items()},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "eager_ms": r.get("eager_ms"), "shape": r["shape"],
                        "max_abs_err_f32": r.get("max_abs_err_f32"),
                        **({"bench_width": r["bench"]} if "bench" in r
                           else {}),
                        **{k: r[k] for k in ("fp8", "b64", "k12_at_decode_ms",
                                             "split_plan", "design", "wide",
                                             "decode", "verify", "models")
                           if k in r}})
        if not kernels[-1]["launches"]:
            raise AssertionError(f"{name} was launched on no path")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
