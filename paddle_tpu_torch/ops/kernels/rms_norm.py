"""RMSNorm forward and dx: the CUDA kernels ``csrc/rms_norm.cu`` and their
plain PyTorch versions, with the autograd pair that joins them.

Port of ``paddle_tpu/ops/pallas/rms_norm.py`` (``rms_norm_reference``,
``_fwd_kernel``/``_rms_fwd_impl``, ``_dx_kernel``/``_rms_bwd``). The
residual-fused pair (``rms_norm_residual``) is not ported yet.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_reference", "rms_norm_dx",
           "rms_norm_dx_reference", "RMSNormFunction"]


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 statistics, cast to x's dtype, then times w."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w


def _check(name, x, *others):
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    d = x.shape[-1]
    for t in others:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match x [..., {d}] "
                             f"{x.dtype} on {x.device}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return d, x.numel() // d if d else 0


def _vec(d, *tensors):
    return (d * tensors[0].element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (one block per row) or raises."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps)
    d, n = _check("rms_norm", x, w)
    if w.shape != (d,):
        raise ValueError(f"rms_norm: weight {tuple(w.shape)} does not "
                         f"match x [..., {d}]")
    code = _build.dtype_code(x.dtype)
    lib = _build.build()
    y = torch.empty_like(x)
    rc = lib.rms_norm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d,
                          float(eps), code, int(_vec(d, x, w, y)),
                          _build.stream_ptr(x.device))
    _build.check(rc, "rms_norm")
    rms_norm.launches += 1
    return y


def rms_norm_dx_reference(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the dx kernel, in f32, rounded once to x's dtype:
    ``inv * g*w - x * inv^3 * mean(g*w*x)``."""
    xf, gw = x.float(), g.float() * w.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    dot = (gw * xf).mean(-1, keepdim=True)
    return (inv * gw - xf * inv ** 3 * dot).to(x.dtype)


def rms_norm_dx(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """dx of RMSNorm for the output gradient ``g``, inv-RMS recomputed. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one block per row) or raises."""
    if x.device.type == "cpu":
        return rms_norm_dx_reference(x, w, g, eps)
    d, n = _check("rms_norm_dx", x, w, g)
    if w.shape != (d,) or g.shape != x.shape:
        raise ValueError(f"rms_norm_dx: w {tuple(w.shape)} and g "
                         f"{tuple(g.shape)} do not match x "
                         f"{tuple(x.shape)}")
    code = _build.dtype_code(x.dtype)
    lib = _build.build()
    dx = torch.empty_like(x)
    rc = lib.rms_norm_bwd_dx(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                             dx.data_ptr(), n, d, float(eps), code,
                             int(_vec(d, x, w, g, dx)),
                             _build.stream_ptr(x.device))
    _build.check(rc, "rms_norm_dx")
    rms_norm_dx.launches += 1
    return dx


#: kernel launches since the last reset (chip_smoke.py reads and zeroes them)
rms_norm.launches = 0
rms_norm_dx.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """``rms_norm`` with its backward: dx from :func:`rms_norm_dx`, dw as
    a plain f32 column reduction of ``g * x * inv`` (the JAX package
    leaves dw to XLA too)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = rms_norm_dx(x, w, g, ctx.eps) if ctx.needs_input_grad[0] \
            else None
        dw = None
        if ctx.needs_input_grad[1]:
            d = x.shape[-1]
            xf = x.reshape(-1, d).float()
            inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + ctx.eps)
            dw = (g.reshape(-1, d).float() * (xf * inv)).sum(0).to(w.dtype)
        return dx, dw, None
