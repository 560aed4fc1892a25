"""RMSNorm forward and dx, plain and residual-fused: the CUDA kernels
``csrc/rms_norm.cu`` and their plain PyTorch versions, with the autograd
pairs that join them.

Port of ``paddle_tpu/ops/pallas/rms_norm.py``: ``rms_norm_reference``,
``_fwd_kernel``/``_rms_fwd_impl`` (K1), ``_dx_kernel``/``_rms_bwd`` (K2),
``rms_norm_residual_reference``, ``_fwd_res_kernel``/``_rms_res_fwd_impl``
(K3) and ``_dres_kernel``/``_rms_res_bwd`` (K4).
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_reference", "rms_norm_dx",
           "rms_norm_dx_reference", "RMSNormFunction",
           "rms_norm_residual", "rms_norm_residual_reference",
           "rms_norm_residual_dh", "rms_norm_residual_dh_reference",
           "RMSNormResidualFunction"]


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 statistics, cast to x's dtype, then times w."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w


def _check(name, x, *others):
    if x.device.type != "cuda":
        raise _build.KernelError(f"{name}: no kernel for device {x.device}")
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


def rms_norm_residual_reference(x: torch.Tensor, res: torch.Tensor,
                                w: torch.Tensor, eps: float = 1e-6):
    """Plain version of K3: ``r = x + res`` in the input dtype (what the
    unfused ``x + res`` gives), then :func:`rms_norm_reference` of r.
    Returns ``(y, r)``."""
    r = x + res
    return rms_norm_reference(r, w, eps), r


def rms_norm_residual(x: torch.Tensor, res: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6):
    """``(rmsnorm(x + res) * w, x + res)`` in one pass. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (one block
    per row) or raises."""
    if x.device.type == "cpu":
        return rms_norm_residual_reference(x, res, w, eps)
    d, n = _check("rms_norm_residual", x, res, w)
    if w.shape != (d,) or res.shape != x.shape:
        raise ValueError(f"rms_norm_residual: res {tuple(res.shape)} and w "
                         f"{tuple(w.shape)} do not match x "
                         f"{tuple(x.shape)}")
    code = _build.dtype_code(x.dtype)
    lib = _build.build()
    y, r = torch.empty_like(x), torch.empty_like(x)
    rc = lib.rms_norm_residual_fwd(x.data_ptr(), res.data_ptr(),
                                   w.data_ptr(), y.data_ptr(), r.data_ptr(),
                                   n, d, float(eps), code,
                                   int(_vec(d, x, res, w, y, r)),
                                   _build.stream_ptr(x.device))
    _build.check(rc, "rms_norm_residual")
    rms_norm_residual.launches += 1
    return y, r


def rms_norm_residual_dh_reference(r: torch.Tensor, w: torch.Tensor,
                                   gy: torch.Tensor, gr: torch.Tensor,
                                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K4, in f32 and rounded once to r's dtype: the
    RMSNorm dx of ``gy`` at ``r = x + res``, plus ``gr``, the gradient
    of the residual stream. It is both dx and dres."""
    rf, gw = r.float(), gy.float() * w.float()
    inv = torch.rsqrt(rf.square().mean(-1, keepdim=True) + eps)
    dot = (gw * rf).mean(-1, keepdim=True)
    return (inv * gw - rf * inv ** 3 * dot + gr.float()).to(r.dtype)


def rms_norm_residual_dh(r: torch.Tensor, w: torch.Tensor, gy: torch.Tensor,
                         gr: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``dh = rms_dx(gy; r) + gr`` with ``r = x + res`` as the forward
    wrote it. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (one block per row) or raises."""
    if r.device.type == "cpu":
        return rms_norm_residual_dh_reference(r, w, gy, gr, eps)
    d, n = _check("rms_norm_residual_dh", r, w, gy, gr)
    if w.shape != (d,) or gy.shape != r.shape or gr.shape != r.shape:
        raise ValueError(f"rms_norm_residual_dh: w {tuple(w.shape)}, gy "
                         f"{tuple(gy.shape)} and gr {tuple(gr.shape)} do "
                         f"not match r {tuple(r.shape)}")
    code = _build.dtype_code(r.dtype)
    lib = _build.build()
    dh = torch.empty_like(r)
    rc = lib.rms_norm_residual_dh(r.data_ptr(), w.data_ptr(), gy.data_ptr(),
                                  gr.data_ptr(), dh.data_ptr(), n, d,
                                  float(eps), code,
                                  int(_vec(d, r, w, gy, gr, dh)),
                                  _build.stream_ptr(r.device))
    _build.check(rc, "rms_norm_residual_dh")
    rms_norm_residual_dh.launches += 1
    return dh


#: kernel launches since the last reset (chip_smoke.py reads and zeroes them)
rms_norm.launches = 0
rms_norm_dx.launches = 0
rms_norm_residual.launches = 0
rms_norm_residual_dh.launches = 0


def _dw(x, g, eps, w_dtype):
    """dw of RMSNorm at input ``x`` for the output gradient ``g``: a plain
    f32 column reduction of ``g * x * inv`` (the JAX package leaves dw to
    XLA too)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (g.reshape(-1, d).float() * (xf * inv)).sum(0).to(w_dtype)


class RMSNormFunction(torch.autograd.Function):
    """``rms_norm`` with its backward: dx from :func:`rms_norm_dx`, dw
    from :func:`_dw`."""

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
        dw = _dw(x, g, ctx.eps, w.dtype) if ctx.needs_input_grad[1] \
            else None
        return dx, dw, None


class RMSNormResidualFunction(torch.autograd.Function):
    """``rms_norm_residual`` with its backward. Both outputs are
    differentiable (r feeds the residual stream). The forward saves r
    (its own output, the same numbers as x + res at half the bytes of x
    and res); the backward's dh from :func:`rms_norm_residual_dh` is the
    gradient of both x and res, and dw comes from :func:`_dw` at r."""

    @staticmethod
    def forward(ctx, x, res, w, eps):
        y, r = rms_norm_residual(x, res, w, eps)
        ctx.save_for_backward(r, w)
        ctx.eps = eps
        return y, r

    @staticmethod
    def backward(ctx, gy, gr):
        r, w = ctx.saved_tensors
        gy = gy.contiguous()
        dh = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dh = rms_norm_residual_dh(r, w, gy, gr.contiguous(), ctx.eps)
        dw = _dw(r, gy, ctx.eps, w.dtype) if ctx.needs_input_grad[2] \
            else None
        return dh, dh, dw, None
