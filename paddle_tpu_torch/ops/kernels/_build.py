"""Build and load the port's CUDA kernels (the counterpart of
``paddle_tpu/ops/pallas/_utils.py``: where the JAX package chose
between compiled and interpreted Pallas, the port chooses between a
kernel built from ``paddle_tpu_torch/csrc`` and the plain PyTorch version
by the device of the tensors it is given).

At first use on a CUDA tensor, every ``csrc/*.cu`` file is compiled by
its own ``nvcc`` process, all started together, for ``sm_90a``; the
objects are linked into one shared library with a plain C interface and
loaded with ``ctypes``. The library's name carries a hash of the sources
and flags, so a changed source is never served from an old build. The
build directory is ``paddle_tpu_torch/_build`` (gitignored), or
``$PADDLE_TPU_TORCH_BUILD_DIR``. A failed build raises ``RuntimeError``
(``KernelError``) with the compiler's output; nothing falls back.

Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelError", "build", "build_seconds", "build_log", "dtype_code",
           "pool_code", "check", "stream_ptr", "CSRC_DIR"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
# C signature of every entry point: argtypes (c_void_p for each pointer
# and the stream, so ctypes never truncates a 64-bit address)
_SIGNATURES = {
    "rms_norm_fwd": [_vp, _vp, _vp, _ll, _i, _f, _i, _i, _vp],
    "rms_norm_bwd_dx": [_vp, _vp, _vp, _vp, _ll, _i, _f, _i, _i, _vp],
    "rms_norm_residual_fwd": [_vp] * 5 + [_ll, _i, _f, _i, _i, _vp],
    "rms_norm_residual_dh": [_vp] * 5 + [_ll, _i, _f, _i, _i, _vp],
    "ce_chunk_stats": [_vp] * 5 + [_i, _i, _i, _i, _i, _vp],
    "ce_chunk_dlogits": [_vp] * 5 + [_i, _i, _i, _i, _i, _vp],
    "swiglu_fwd": [_vp, _vp, _vp, _ll, _i, _i, _vp],
    "swiglu_bwd": [_vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _vp],
    "flash_attention_fwd": [_vp] * 5 + [_i] * 6 + [_f, _i, _i, _vp],
    "flash_attention_dkv": [_vp] * 8 + [_i] * 6 + [_f, _i, _i, _vp],
    "flash_attention_dq": [_vp] * 7 + [_i] * 6 + [_f, _i, _i, _vp],
    "ragged_paged_attention_fwd": [_vp] * 7 + [_i] * 8
                                  + [_f, _i, _i, _i, _vp, _vp, _vp],
    "ragged_paged_attention_quant_fwd": [_vp] * 9 + [_i] * 8
                                        + [_f, _i, _i, _i, _i, _vp, _vp,
                                           _vp],
    "paged_attention_fwd": [_vp] * 6 + [_i] * 7 + [_f, _i, _i, _i, _vp],
    "grouped_matmul_fwd": [_vp] * 4 + [_i] * 7 + [_vp],
    "grouped_matmul_dw": [_vp] * 4 + [_i] * 6 + [_vp],
}


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched. The serving
    engine's step-failure containment never absorbs it: it propagates."""


class _Built:
    lib = None
    seconds = None
    log = ""
    dtype_codes = None


def _build_dir() -> Path:
    env = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG_DIR / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found on PATH or under /usr/local/cuda: "
                       "the port's CUDA kernels cannot be built")


def _sources():
    cu = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    if not cu:
        raise KernelError(f"no CUDA sources under {CSRC_DIR}")
    return cu, headers


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc, sources, out_dir: Path) -> tuple[list[Path], str]:
    """One nvcc per source, all running at once; raises on any failure."""
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode})")
    log = "\n".join(logs)
    if failed:
        raise KernelError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    return [obj for _, obj, _ in procs], log


def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and load it. Idempotent."""
    if _Built.lib is not None:
        return _Built.lib
    t0 = time.perf_counter()
    cu, headers = _sources()
    name = f"libpaddle_tpu_torch_kernels_{_digest(cu + headers)}.so"
    so = _build_dir() / name
    log = ""
    if not so.exists():
        nvcc = _nvcc()
        work = so.with_suffix(f".{os.getpid()}.d")
        work.mkdir(parents=True, exist_ok=True)
        objs, log = _compile(nvcc, cu, work)
        tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelError(f"linking the kernel library failed:\n"
                               f"{link.stdout}")
        os.replace(tmp, so)
        shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _Built.lib, _Built.log = lib, log
    _Built.seconds = time.perf_counter() - t0
    return lib


def build_seconds() -> float | None:
    """Seconds the first :func:`build` took in this process (None before)."""
    return _Built.seconds


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    return _Built.log


def dtype_code(dtype) -> int:
    """The kernels' dtype code (csrc/common.cuh: kFloat32, kBFloat16)."""
    codes = _Built.dtype_codes
    if codes is None:
        import torch
        codes = _Built.dtype_codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return codes[dtype]


def pool_code(dtype) -> int:
    """The code of a quantized KV pool's dtype (csrc/common.cuh: kInt8,
    kFloat8E4M3)."""
    import torch
    codes = {torch.int8: 2, torch.float8_e4m3fn: 3}
    if dtype not in codes:
        raise TypeError(f"quantized KV pools are int8 or float8_e4m3fn, "
                        f"not {dtype}")
    return codes[dtype]


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc} at launch "
                           f"(cudaGetLastError)")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
