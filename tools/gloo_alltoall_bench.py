#!/usr/bin/env python3
"""Time an all-to-all between two ranks sharing one NVIDIA GPU.

    python3 tools/gloo_alltoall_bench.py              # [60, 1024, 3584] bf16
    python3 tools/gloo_alltoall_bench.py 8 256 1024 float32

Two ranks (``paddle_tpu_torch.distributed.spawn``) join a gloo group on
the same card, as ``chip_smoke.py``'s phase tp does, and each holds a
CUDA tensor of the given shape from its own seed (by default the slot
tensor ``[E, C, d]`` that each rank of ``qwen2_moe_a14b``'s width at ep 2
hands to an expert all-to-all: 60 experts, 1024 slots, 3584 wide, bf16).
Each sends half of dim 0 to each rank through the all-gather build (the
parts stacked, ``communication.all_gather`` of the stack, widened to f32
on the host for bf16, and this rank's column) and through
``communication.alltoall`` (an ``isend``/``irecv`` pair of the parts'
bytes with each other rank), in the order all_gather, alltoall,
alltoall, all_gather, and checks the two results equal bit for bit.
Prints the card's name and power limit first, then rank 0's seconds per
run.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _rank(shape, dtype_name, out):
    import torch
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env()
    rank = env.get_rank()
    g = C.get_group()
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(rank)
    x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    parts = list(x.chunk(2))
    results, lines = {}, []
    for mode in ("all_gather", "alltoall", "alltoall", "all_gather"):
        torch.cuda.synchronize()
        C.barrier()
        t0 = time.perf_counter()
        if mode == "all_gather":
            rows = C.all_gather([], torch.stack(parts), g)
            got = torch.cat([r[g.rank] for r in rows])
            del rows
        else:
            got = torch.cat(C.alltoall([], parts, g))
        torch.cuda.synchronize()
        lines.append(f"{mode}: {time.perf_counter() - t0:.3f} s")
        results.setdefault(mode, got)
        del got
    same = torch.equal(results["all_gather"], results["alltoall"])
    if rank == 0:
        with open(out, "w") as f:
            f.write(f"the all-to-all of {list(shape)} {dtype_name} "
                    f"({x.numel() * x.element_size() / 1e9:.3f} GB a rank) "
                    f"over 2 ranks (gloo) on one card: " + ", ".join(lines)
                    + f"; equal bit for bit: {same}\n")
    if not same:
        raise SystemExit(f"rank {rank}: the two paths disagree")


def main():
    import torch
    if not torch.cuda.is_available():
        print("gloo_alltoall_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from paddle_tpu_torch.distributed import spawn
    args = sys.argv[1:]
    shape = tuple(int(a) for a in args[:3]) if len(args) >= 3 \
        else (60, 1024, 3584)
    dtype_name = args[3] if len(args) > 3 else "bfloat16"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.txt")
        spawn(_rank, args=(shape, dtype_name, out), nprocs=2, join=True,
              timeout=900)
        with open(out) as f:
            print(f.read().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
