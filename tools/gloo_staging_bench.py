#!/usr/bin/env python3
"""Time a gradient average between two ranks sharing one NVIDIA GPU.

    python3 tools/gloo_staging_bench.py             # 1.487e9 bf16 values
    python3 tools/gloo_staging_bench.py 100000000 float16

Two ranks (``paddle_tpu_torch.distributed.spawn``) join a gloo group on
the same card, as ``chip_smoke.py``'s phase tp does, and each holds a
CUDA tensor of N values from its own seed (by default the gradient count
of the Llama-3-8B width at 2 layers, the sep cases' model, in bf16).
Each averages it over the two ranks through the widened path (a host
copy widened to f32, gloo's sum, the division, rounded back on the way
to the card) and through ``communication.all_reduce(AVG)`` (for bf16 or
f16 over two ranks: the bytes swapped by an all-gather and added in f32
on the card), in the order widened, all_reduce, all_reduce, widened,
and checks the two results equal bit for bit. Prints the card's name and
power limit first, then rank 0's seconds per run.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _rank(n, dtype_name, out):
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env()
    rank = env.get_rank()
    g = C.get_group()
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(rank)
    x = torch.randn(n, device="cuda", generator=gen).to(dtype)
    results, lines = {}, []
    for mode in ("widened", "all_reduce", "all_reduce", "widened"):
        t = x.clone()
        torch.cuda.synchronize()
        C.barrier()
        t0 = time.perf_counter()
        if mode == "widened":
            buf = C._host(g, t)
            dist.all_reduce(buf, dist.ReduceOp.SUM)
            buf.div_(2)
            C._back(t, buf)
            del buf
        else:
            C.all_reduce(t, C.ReduceOp.AVG)
        torch.cuda.synchronize()
        lines.append(f"{mode}: {time.perf_counter() - t0:.3f} s")
        if mode in results:
            del t
        else:
            results[mode] = t
    same = torch.equal(results["widened"], results["all_reduce"])
    if rank == 0:
        with open(out, "w") as f:
            f.write(f"the mean of {n} {dtype_name} values "
                    f"({n * x.element_size() / 1e9:.2f} GB a rank) over 2 "
                    f"ranks (gloo) on one card: " + ", ".join(lines)
                    + f"; equal bit for bit: {same}\n")
    if not same:
        raise SystemExit(f"rank {rank}: the two paths disagree")


def main():
    import torch
    if not torch.cuda.is_available():
        print("gloo_staging_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from paddle_tpu_torch.distributed import spawn
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_487_000_000
    dtype_name = sys.argv[2] if len(sys.argv) > 2 else "bfloat16"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.txt")
        spawn(_rank, args=(n, dtype_name, out), nprocs=2, join=True,
              timeout=900)
        with open(out) as f:
            print(f.read().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
