#!/usr/bin/env python3
"""Time the design options a kernel's redesign weighed, on one NVIDIA GPU.

    python3 tools/cuda_variants.py        # from the root of the repository
    python3 tools/cuda_variants.py k16    # one kernel's variants (k16, k10)

Each variant is the kernel's source in ``paddle_tpu_torch/csrc`` with a
few lines replaced (a constant, a plan, a step left out), built by its
own ``nvcc`` into a library of its own under the build directory and
called through the same C entry point as the port's wrapper, on the
inputs ``chip_smoke.py`` times the kernel on; "as is" is the source
unchanged. Times are device time a call (``chip_smoke.time_ms``: a CUDA
graph of 20 calls cycling through input copies that span three L2
sizes, the median of five windows). Every variant's output is compared
with the plain version; a variant that leaves a step out to bound its
cost says so and is not held to it.

K16 (``csrc/paged_attention.cu``, the split body): the ring's stages and
keys a stage, the split plan with half or twice the splits, and the
cluster merge left out (rank 0 normalises its own split: the lower bound
of a merge of any kind), or only its reads of the other ranks (the cost
of the two cluster barriers alone); and how many clusters of each size
the card holds at once. K10 (``csrc/ce_chunk.cu``): resident blocks an
SM (the registers a thread may hold), rows a block, vectors a slab.

Prints the card's name and power limit first; needs nvcc and a GPU.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

K16_SRC = "paged_attention.cu"
K10_SRC = "ce_chunk.cu"
_STAGES = "constexpr int kStages = 3;"
_TILE = ("constexpr int kTile = 32;                     // keys a ring "
         "stage")
_MERGE = "        if (s < n_splits) {\n          ml[s] = hw::ld_cluster_f2("
_BARRIERS = "  hw::cluster_arrive();\n  hw::cluster_wait();\n"
K16_VARIANTS = {
    "as is": [],
    "4 stages": [(_STAGES, "constexpr int kStages = 4;")],
    "64 keys a stage": [(_TILE, "constexpr int kTile = 64;")],
    "64 keys a stage, 2 stages": [(_TILE, "constexpr int kTile = 64;"),
                                  (_STAGES, "constexpr int kStages = 2;")],
    "no merge (lower bound)": [(_MERGE, _MERGE.replace("n_splits", "1")),
                               (_BARRIERS, "")],
    "barriers, no reads (lower bound)": [
        (_MERGE, _MERGE.replace("n_splits", "1"))],
}
_BLOCKS = "constexpr int kStatsBlocks = 4;"
_ROWS = "constexpr int kRowsPerBlock = 8;"
_SLAB = "constexpr int kSlabVecs = 4;"
K10_VARIANTS = {
    "as is": [],
    "5 blocks an SM": [(_BLOCKS, _BLOCKS.replace("4", "5"))],
    "6 blocks an SM": [(_BLOCKS, _BLOCKS.replace("4", "6"))],
    "16 rows a block, 2 blocks an SM": [(_ROWS, _ROWS.replace("8", "16")),
                                        (_BLOCKS, _BLOCKS.replace("4", "2"))],
    "2 vectors a slab": [(_SLAB, _SLAB.replace("4", "2"))],
}


def build(src_name, variants, probe=""):
    """Every variant of one source, compiled at once (``probe`` appended
    to the source as is); returns {name: (ctypes library, ptxas summary
    lines)}."""
    from paddle_tpu_torch.ops.kernels import _build
    src = (_build.CSRC_DIR / src_name).read_text()
    out_dir = _build._build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        text = src + (probe if name == "as is" else "")
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{src_name} variant {name!r}: "
                                   f"{old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{Path(src_name).stem}_{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC_DIR), "-shared", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src_name} {name!r}:\n"
                               f"{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if hasattr(lib, "k16_max_clusters"):
            lib.k16_max_clusters.argtypes = [ctypes.c_int] * 4
            lib.k16_max_clusters.restype = ctypes.c_int
        libs[name] = (lib, [line for line in cs._ptxas_summary(log)
                            if not line.startswith("==")])
    return libs


# appended to the source as is: how many clusters of n CTAs of the split
# body the card holds at once (the occupancy API, no launch)
PROBE = """
extern "C" int k16_max_clusters(int rep_rows, int n, int split_len,
                                int page_shift) {
  const uint32_t smem =
      rep_rows == 8
          ? split::Smem<128, 8>::pages + 4 * ((split_len >> page_shift) + 2)
          : split::Smem<128, 4>::pages + 4 * ((split_len >> page_shift) + 2);
  auto kernel = rep_rows == 8 ? split::paged_split<128, 8>
                              : split::paged_split<128, 4>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(split::kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}
"""


def k16(libs):
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as kpa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16 = torch.bfloat16

    def call(lib, plan):
        def fn(q, kp, vp, tb, ct):
            out = torch.empty_like(q)
            b, h, d = q.shape
            kvh, n_pages, page, _ = kp.shape
            _build.check(lib.paged_attention_fwd(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tb.data_ptr(),
                ct.data_ptr(), out.data_ptr(), b, h, kvh, d, n_pages, page,
                tb.shape[1], d ** -0.5, _build.dtype_code(bf16), plan[0],
                plan[1], _build.stream_ptr(dev)), "paged_attention")
            return out
        return fn

    max_len, page, d = 2048, 16, 128
    mp = max_len // page
    probe = libs["as is"][0]
    for rows in (4, 8):
        for n in (1, 2, 4, 8):
            length = -(-mp * page // n // 64) * 64
            held = probe.k16_max_clusters(rows, n, length, 4)
            cs.log(f"[K16] clusters of {n} CTAs (rep rows {rows}) the card "
                   f"holds at once: {held}")
    for nh, kvh in ((32, 8), (28, 4)):
        for b in (8, 64):
            ctx = np.linspace(64, max_len, b).astype(np.int32)
            n_pages = b * mp + 1
            tb, ct = (torch.from_numpy(a).to(dev) for a in (
                cs._mixed_tables(b, n_pages, mp, page, ctx,
                                 np.zeros(b, np.int32), 13), ctx))
            kp = torch.randn(kvh, n_pages, page, d, device=dev,
                             generator=gen).to(bf16)
            vp = torch.randn(kvh, n_pages, page, d, device=dev,
                             generator=gen).to(bf16)
            kp[:, 0] = vp[:, 0] = float("nan")
            q = torch.randn(b, nh, d, device=dev, generator=gen).to(bf16)
            args = (q, kp, vp, tb, ct)
            f32 = [t.float() for t in (q, kp, vp)]
            ref = kpa.paged_attention_reference(*f32, tb, ct)
            a = kpa.paged_attention_reference(f32[0], f32[1], f32[2].abs(),
                                              tb, ct)
            tol = cs.BF16_ULP * ref.abs() + 1e-5 * a + 1e-6
            n, length = kpa.decode_split_plan(b, kvh, nh // kvh, d,
                                              mp * page)
            keys = int(ctx.sum())
            b_ms, b_by = cs.bound(2 * b * nh * d * 2 + 2 * keys * kvh * d * 2
                                  + b * (mp + 1) * 4, 4 * d * nh * keys,
                                  cs.PEAK_BF16)
            cs.log(f"[K16] {nh}/{kvh} heads B={b}: bound {b_ms:.4f} ms "
                   f"({b_by})")
            units = -(-mp * page // 64)
            plans = {(n, length)}
            for m in (max(1, n // 2), min(8, 2 * n)):
                sl = -(-units // m) * 64
                plans.add((-(-mp * page // sl), sl))
            for name, (lib, _) in libs.items():
                for plan in sorted(plans):
                    if name != "as is" and plan != (n, length):
                        continue
                    fn = call(lib, plan)
                    out = fn(*args)
                    torch.cuda.synchronize()
                    held = bool(((out.float() - ref).abs() <= tol).all())
                    ms = cs.time_ms(fn, args)
                    note = "" if held else (
                        " (output not held: a step left out)"
                        if "lower bound" in name else " FAILS the check")
                    mine = " (the wrapper's)" if plan == (n, length) else ""
                    cs.log(f"[K16] {nh}/{kvh} heads B={b}: {name}, plan "
                           f"{plan}{mine}: {ms:.4f} ms{note}")
            del kp, vp, q, f32, ref, a, tol


def k10(libs):
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import ce_chunk as kce
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)

    def call(lib):
        def fn(logits, local, lo):
            n, vc = logits.shape
            m, s, t = torch.empty(3, n, dtype=torch.float32, device=dev)
            _build.check(lib.ce_chunk_stats(
                logits.data_ptr(), local.data_ptr(), m.data_ptr(),
                s.data_ptr(), t.data_ptr(), n, vc, lo,
                _build.dtype_code(logits.dtype), 1,
                _build.stream_ptr(dev)), "chunk_stats")
            return m, s, t
        return fn

    n = 8192
    for vc, dtype, lo in ((1024, torch.bfloat16, 0),
                          (1024, torch.bfloat16, 768),
                          (1024, torch.float32, 0), (4096, torch.bfloat16, 0)):
        logits = (3 * torch.randn(n, vc, device=dev, generator=gen)).to(dtype)
        local = torch.randint(lo, vc, (n,), device=dev, generator=gen,
                              dtype=torch.int32)
        rm, rs, rt = kce.chunk_stats_reference(logits, local, lo)
        b_ms, b_by = cs.bound(n * vc * logits.element_size() + 16 * n,
                              5 * n * vc, cs.PEAK_F32_CORES)
        cs.log(f"[K10] [{n}, {vc}] {str(dtype)[6:]} lo={lo}: bound "
               f"{b_ms:.4f} ms ({b_by})")
        for name, (lib, _) in libs.items():
            m, s, t = call(lib)(logits, local, lo)
            torch.cuda.synchronize()
            held = (torch.equal(m, rm) and torch.equal(t, rt)
                    and bool(((s - rs).abs() <= 2e-5 * rs).all()))
            ms = cs.time_ms(call(lib), (logits, local, lo))
            cs.log(f"[K10] [{n}, {vc}] {str(dtype)[6:]} lo={lo}: {name}: "
                   f"{ms:.4f} ms{'' if held else ' FAILS the check'}")
        del logits, local


def main():
    import torch
    if not torch.cuda.is_available():
        print("cuda_variants: no CUDA device", file=sys.stderr)
        return 1
    only = set(sys.argv[1:]) or {"k16", "k10"}
    cs.phase_setup()
    for key, src, variants, run, probe in (
            ("k16", K16_SRC, K16_VARIANTS, k16, PROBE),
            ("k10", K10_SRC, K10_VARIANTS, k10, "")):
        if key not in only:
            continue
        libs = build(src, variants, probe)
        for name, (_, lines) in libs.items():
            for line in lines:
                if "paged_split<128, 4>" in line or "ce_stats" in line:
                    cs.log(f"[ptxas] {src} {name}: {line}")
        run(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
