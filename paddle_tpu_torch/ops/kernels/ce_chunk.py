"""The fused linear+CE's per-chunk kernels: the CUDA kernels
``csrc/ce_chunk.cu`` and their plain PyTorch versions.

Port of ``paddle_tpu/ops/pallas/ce_chunk.py``: ``chunk_stats`` (K10,
``_stats_kernel``) and ``chunk_dlogits`` (K11, ``_dlogits_kernel``). The
plain versions follow the jnp scan body of ``paddle_tpu/ops/fused_ce.py``
(the target gathered at ``local`` where it lies in ``[lo, vc)``; an iota
compare instead of a one-hot for dlogits). ``lo`` masks the overlap
prefix of the clamped tail chunk: the columns below it belong to the
previous chunk.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["chunk_stats", "chunk_stats_reference", "chunk_dlogits",
           "chunk_dlogits_reference"]


def chunk_stats_reference(logits: torch.Tensor, local: torch.Tensor,
                          lo: int):
    """Plain version of K10, in f32: per row of ``logits [N, vc]`` over
    the columns ``>= lo``, the max ``m``, ``s = sum(exp(x - m))`` and the
    target logit ``t = x[local]`` (0 where ``local`` is outside
    ``[lo, vc)``). A row with no column left gives ``m = -inf, s = 0``.
    Returns ``(m, s, t)``, f32 [N] each."""
    x = logits.float()
    vc = x.shape[-1]
    valid = torch.arange(vc, device=x.device) >= lo
    m = torch.where(valid, x, float("-inf")).amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.where(valid, torch.exp(x - m_safe[:, None]), 0.0).sum(-1)
    local = local.long()
    in_chunk = (local >= lo) & (local < vc)
    picked = x.gather(-1, local.clamp(0, vc - 1)[:, None])[:, 0]
    return m, s, torch.where(in_chunk, picked, 0.0)


def chunk_dlogits_reference(logits: torch.Tensor, lse: torch.Tensor,
                            local: torch.Tensor, scale: torch.Tensor,
                            lo: int) -> torch.Tensor:
    """Plain version of K11: ``(softmax - onehot) * scale`` in f32 with
    the softmax ``exp(x - lse)``, columns below ``lo`` set to 0, rounded
    once to the logits' dtype (h's: the JAX op's ``out_dtype``)."""
    x = logits.float()
    col = torch.arange(x.shape[-1], device=x.device)[None, :]
    valid = col >= lo
    p = torch.where(valid, torch.exp(x - lse.float()[:, None]), 0.0)
    hit = ((col == local.long()[:, None]) & valid).float()
    return ((p - hit) * scale.float()[:, None]).to(logits.dtype)


def _check(name, logits, lo, **vectors):
    if logits.device.type != "cuda":
        raise _build.KernelError(
            f"{name}: no kernel for device {logits.device}")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError(f"{name}: logits must be a contiguous [N, vc] "
                         f"block, not {tuple(logits.shape)}")
    n, vc = logits.shape
    if not 0 <= int(lo) <= vc:
        raise ValueError(f"{name}: lo={lo} outside [0, {vc}]")
    for key, (t, dtype) in vectors.items():
        if (t.shape != (n,) or t.dtype != dtype or t.device != logits.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be contiguous {dtype} "
                             f"[{n}] on {logits.device}, not "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return n, vc


def _vec(logits, *blocks):
    return (logits.shape[1] * logits.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (logits, *blocks)))


def chunk_stats(logits: torch.Tensor, local: torch.Tensor, lo: int):
    """Per-chunk online-softmax statistics ``(m, s, t)``, f32 [N] each,
    of ``logits [N, vc]`` (float32 or bfloat16) for the int32 labels
    ``local`` (the row's label minus the chunk's first column). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (one warp per row) or raises."""
    if logits.device.type == "cpu":
        return chunk_stats_reference(logits, local, lo)
    n, vc = _check("chunk_stats", logits, lo, local=(local, torch.int32))
    code = _build.dtype_code(logits.dtype)
    lib = _build.build()
    m, s, t = torch.empty(3, n, dtype=torch.float32, device=logits.device)
    rc = lib.ce_chunk_stats(logits.data_ptr(), local.data_ptr(),
                            m.data_ptr(), s.data_ptr(), t.data_ptr(), n, vc,
                            int(lo), code, int(_vec(logits)),
                            _build.stream_ptr(logits.device))
    _build.check(rc, "chunk_stats")
    chunk_stats.launches += 1
    return m, s, t


def chunk_dlogits(logits: torch.Tensor, lse: torch.Tensor,
                  local: torch.Tensor, scale: torch.Tensor,
                  lo: int) -> torch.Tensor:
    """The backward's ``(softmax - onehot) * scale`` for one chunk:
    ``lse`` the saved log-sum-exp and ``scale`` the per-row loss scale
    (0 for ignored rows), both f32 [N]; ``[N, vc]`` in the logits'
    dtype. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (one warp per row) or raises."""
    if logits.device.type == "cpu":
        return chunk_dlogits_reference(logits, lse, local, scale, lo)
    n, vc = _check("chunk_dlogits", logits, lo, lse=(lse, torch.float32),
                   local=(local, torch.int32), scale=(scale, torch.float32))
    code = _build.dtype_code(logits.dtype)
    lib = _build.build()
    out = torch.empty_like(logits)
    rc = lib.ce_chunk_dlogits(logits.data_ptr(), lse.data_ptr(),
                              local.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), n, vc, int(lo), code,
                              int(_vec(logits, out)),
                              _build.stream_ptr(logits.device))
    _build.check(rc, "chunk_dlogits")
    chunk_dlogits.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads and zeroes them)
chunk_stats.launches = 0
chunk_dlogits.launches = 0
