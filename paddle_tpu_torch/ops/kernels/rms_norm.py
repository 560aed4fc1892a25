"""RMSNorm forward: the CUDA kernel ``csrc/rms_norm.cu`` and its plain
PyTorch version.

Port of ``paddle_tpu/ops/pallas/rms_norm.py`` (``rms_norm_reference``,
``_fwd_kernel``, ``_rms_fwd_impl``), forward only: serving needs no
backward. The residual-fused variant and the backward kernels come with
training.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_reference"]


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 statistics, cast to x's dtype, then times w."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (one block per row) or raises."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rms_norm: no kernel for device {x.device}")
    d = x.shape[-1]
    if w.shape != (d,) or w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"rms_norm: weight {tuple(w.shape)} {w.dtype} "
                         f"on {w.device} does not match x "
                         f"[..., {d}] {x.dtype} on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm: the kernel takes contiguous tensors")
    code = _build.dtype_code(x.dtype)
    lib = _build.build()
    y = torch.empty_like(x)
    n = x.numel() // d if d else 0
    vec = (d * x.element_size() % 16 == 0
           and all(t.data_ptr() % 16 == 0 for t in (x, w, y)))
    rc = lib.rms_norm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d,
                          float(eps), code, int(vec),
                          _build.stream_ptr(x.device))
    _build.check(rc, "rms_norm")
    rms_norm.launches += 1
    return y


#: kernel launches since the last reset (chip_smoke.py reads and zeroes it)
rms_norm.launches = 0
