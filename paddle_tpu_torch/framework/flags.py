"""Runtime flags: a copy of ``paddle_tpu/framework/flags.py`` with its 24
flags, under the same names, defaults, types and environment parsing.

Every flag records where its value came from: ``"default"`` (the
``define_flag`` literal), ``"env"`` (a ``FLAGS_*`` environment variable
when the flag was defined) or ``"set"`` (a :func:`set_flags` call).
Anything but ``"default"`` is an explicit choice, and an explicit choice
wins over a :class:`scoped_default`. A flag's ``on_change`` callback runs
after each :func:`set_flags` of it and when a :class:`scoped_default`
applies or rolls back (outside the lock, as in the JAX package).

What each flag means in the port:

- The kernel routes (``FLAGS_enable_pallas_kernels``,
  ``FLAGS_fused_swiglu``, ``FLAGS_flash_attn_pallas_bwd``,
  ``FLAGS_fused_ce_pallas_inner``, ``FLAGS_use_pallas_paged_attention``,
  ``FLAGS_use_pallas_ragged_attention``) default to on, where the port
  launches its CUDA kernels for CUDA tensors. Off, the op takes its plain
  PyTorch version on purpose, as the JAX package takes its jnp path.
- The Pallas tiles (``FLAGS_flash_attn_block_q/kv``,
  ``FLAGS_ragged_attn_q_block/kv_pages``) are accepted; the CUDA kernels'
  tiles are their own.
- Flags whose reader the port lacks say in their help which ROADMAP item
  brings it; the compatibility flags are accepted, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

__all__ = ["define_flag", "flag", "flag_source", "get_flags", "set_flags",
           "scoped_default"]

_lock = threading.Lock()
_registry: dict[str, dict] = {}


def _key(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def _parse_env(value: str, typ):
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def define_flag(name: str, default: Any, help: str = "",
                on_change: Callable[[Any], None] | None = None) -> None:
    """Define ``FLAGS_<name>``; an environment variable of that name, if
    it parses, gives the initial value. ``on_change(value)`` runs on each
    later change (not for the environment's value)."""
    name = _key(name)
    typ = type(default)
    value, source = default, "default"
    env = os.environ.get(name)
    if env is not None:
        try:
            value, source = _parse_env(env, typ), "env"
        except (TypeError, ValueError):
            pass
    with _lock:
        _registry[name] = {"value": value, "default": default, "help": help,
                           "type": typ, "on_change": on_change,
                           "source": source}


def flag(name: str) -> Any:
    return _registry[_key(name)]["value"]


def flag_source(name: str) -> str:
    """``"default"``, ``"env"`` or ``"set"``."""
    return _registry[_key(name)]["source"]


def get_flags(names=None) -> dict[str, Any]:
    if names is None:
        return {k: v["value"] for k, v in _registry.items()}
    if isinstance(names, str):
        names = [names]
    return {_key(n): _registry[_key(n)]["value"] for n in names}


def set_flags(flags: dict[str, Any]) -> None:
    """Set flags explicitly (their source becomes ``"set"``); an unknown
    name raises ``KeyError``."""
    for k, v in flags.items():
        with _lock:
            ent = _registry.get(_key(k))
            if ent is None:
                raise KeyError(f"unknown flag {_key(k)!r}")
            ent["value"] = v if isinstance(v, ent["type"]) \
                else ent["type"](v)
            ent["source"] = "set"
            cb, val = ent["on_change"], ent["value"]
        if cb is not None:
            cb(val)


class scoped_default:
    """Context manager giving ``name`` another default for the scope.

    It applies only while the flag's value is still the ``define_flag``
    default: an environment variable or a :func:`set_flags` call wins.
    The source stays ``"default"``, and the value is restored on exit
    unless something set the flag explicitly inside the scope."""

    def __init__(self, name: str, value: Any):
        self._name = _key(name)
        self._value = value
        self._applied = False

    def __enter__(self):
        cb = val = None
        with _lock:
            ent = _registry[self._name]
            self._prev = ent["value"]
            if ent["source"] == "default":
                ent["value"] = val = ent["type"](self._value)
                self._applied = True
                cb = ent["on_change"]
        if cb is not None:
            cb(val)
        return self

    def __exit__(self, *exc):
        cb = None
        with _lock:
            ent = _registry[self._name]
            if self._applied and ent["source"] == "default":
                ent["value"] = self._prev
                cb = ent["on_change"]
        if cb is not None:
            cb(self._prev)
        return False


# ---- compatibility flags: accepted, as in the JAX package -------------------
define_flag("FLAGS_check_nan_inf", False,
            "Check outputs for NaN/Inf after each op (debug). Accepted; "
            "amp.debugging.enable_check_nan_inf() turns the check on.")
define_flag("FLAGS_cudnn_deterministic", False,
            "Accepted for compatibility (the port's kernels repeat their "
            "bits from launch to launch).")
define_flag("FLAGS_use_stride_kernel", False, "Accepted for compatibility.")
define_flag("FLAGS_embedding_deterministic", 0,
            "Accepted for compatibility.")
define_flag("FLAGS_allocator_strategy", "auto_growth",
            "Accepted for compatibility (PyTorch's caching allocator owns "
            "device memory).")
define_flag("FLAGS_fraction_of_gpu_memory_to_use", 0.92,
            "Accepted for compatibility.")
define_flag("FLAGS_log_level", 1, "Framework log verbosity.")


def _toggle_host_trace(value):
    # lazy import: the flags load before the profiler package. The flag
    # toggle never writes files; profiler.disable() exports on stop.
    from ..profiler import disable, enable
    enable() if value else disable(export=False)


define_flag("FLAGS_enable_host_trace", False,
            "Structured host trace layer (paddle_tpu_torch.profiler."
            "trace): spans and gauges recorded process-wide, chrome-trace "
            "export on disable. Same switch as PADDLE_PROFILER_TRACE=1.",
            on_change=_toggle_host_trace)
define_flag("FLAGS_host_trace_level", 1,
            "Reserved verbosity knob for the host trace layer (the tracer "
            "records every span when enabled).")
define_flag("FLAGS_tpu_matmul_precision", "default",
            "Matmul precision: default|high|highest. Accepted; its reader "
            "(the JAX package's ops.linalg.matmul) comes with ROADMAP A.8, "
            "the rest of the ops.")

# ---- the kernel routes (module docstring) ----------------------------------
define_flag("FLAGS_enable_pallas_kernels", True,
            "Launch the port's CUDA kernels (RMSNorm K1-K4, SwiGLU K5/K6, "
            "flash attention K7-K9) for CUDA tensors; off, those ops take "
            "their plain PyTorch versions.")
define_flag("FLAGS_flash_attn_block_q", 256,
            "Pallas flash-attn q block. Accepted; the CUDA kernels' tiles "
            "are their own (csrc/flash_attention.cu).")
define_flag("FLAGS_flash_attn_block_kv", 512,
            "Pallas flash-attn kv block. Accepted; the CUDA kernels' tiles "
            "are their own (csrc/flash_attention.cu).")
define_flag("FLAGS_recompute_policy", "dots_saveable",
            "What recompute() keeps from its forward: dots_saveable "
            "(default) | nothing_saveable | "
            "dots_with_no_batch_dims_saveable | everything_saveable | "
            "dots_and_flash_saveable (incubate/recompute.py).")
define_flag("FLAGS_flash_attn_pallas_bwd", True,
            "Flash attention's backward through the dk/dv and dq kernels "
            "(K8/K9); off, through their plain PyTorch versions.")
define_flag("FLAGS_use_pallas_paged_attention", 1,
            "ops.paged_attention.paged_attention (the decode-step op and "
            "the incubate API): the decode kernel K16 for CUDA tensors "
            "(0 = its plain PyTorch version).")
define_flag("FLAGS_use_pallas_ragged_attention", 1,
            "The serving step's ragged paged attention: kernels K12/K13 "
            "for CUDA tensors (0 = their plain PyTorch versions).")
define_flag("FLAGS_ragged_attn_q_block", 16,
            "Ragged paged attention: stream tokens per q program (Pallas). "
            "Accepted; the CUDA kernels' tiles and splits are their own "
            "(csrc/ragged_paged_attention.cu).")
define_flag("FLAGS_ragged_attn_kv_pages", 4,
            "Ragged paged attention: KV pages per block (Pallas). "
            "Accepted; the CUDA kernels' tiles and splits are their own.")
define_flag("FLAGS_fused_linear_cross_entropy", False,
            "The labelled forward's loss through ops.fused_ce (vocab "
            "chunks, never the [N, V] logits); it then returns (None, "
            "loss). hapi.Model.fit(compiled=True) turns it on with "
            "scoped_default.")
define_flag("FLAGS_fused_ce_chunk_v", 1024,
            "Vocab columns per chunk of the fused linear+CE. The JAX "
            "package's tuner cache behind it comes with ROADMAP A.6.")
define_flag("FLAGS_fused_ce_pallas_inner", True,
            "Fused linear+CE: each chunk's softmax statistics and dlogits "
            "through the kernels K10/K11 (0 = their plain PyTorch "
            "versions).")
define_flag("FLAGS_fused_rmsnorm_residual", True,
            "Llama's unrolled training stack carries the un-added "
            "(hidden, residual) pair between layers, so every residual add "
            "and the RMSNorm after it are one kernel pair (K3/K4); Qwen2 "
            "and DeepSeek fuse the post-attention pair in place.")
define_flag("FLAGS_fused_swiglu", True,
            "MLP: silu(gate) * up through the SwiGLU kernels K5/K6 (with "
            "FLAGS_enable_pallas_kernels); off, the plain composition.")

# the flags that choose between a kernel and its plain version
KERNEL_ROUTES = ("FLAGS_enable_pallas_kernels", "FLAGS_fused_swiglu",
                 "FLAGS_flash_attn_pallas_bwd", "FLAGS_fused_ce_pallas_inner",
                 "FLAGS_use_pallas_paged_attention",
                 "FLAGS_use_pallas_ragged_attention")
