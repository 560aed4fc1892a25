"""SwiGLU forward and backward: the CUDA kernels ``csrc/swiglu.cu`` and
their plain PyTorch versions, with the autograd pair that joins them.

Port of ``paddle_tpu/ops/pallas/swiglu.py`` (``swiglu_reference``,
``_fwd_kernel``/``_swiglu_fwd_impl``, ``_bwd_kernel``/``_swiglu_bwd``):
the backward takes the raw inputs and recomputes the sigmoid, so no silu
intermediate is saved.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["swiglu", "swiglu_reference", "swiglu_bwd",
           "swiglu_bwd_reference", "SwiGLUFunction"]


def swiglu_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain version: ``silu(gate) * up`` in the input dtype, exactly the
    unfused functional's math."""
    return F.silu(gate) * up


def _check(name, gate, *others):
    if gate.device.type != "cuda":
        raise _build.KernelError(f"{name}: no kernel for device {gate.device}")
    for t in others:
        if (t.shape != gate.shape or t.dtype != gate.dtype
                or t.device != gate.device):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match gate "
                             f"{tuple(gate.shape)} {gate.dtype}")
    if not all(t.is_contiguous() for t in (gate, *others)):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _vec(*tensors):
    n = tensors[0].numel()
    return (n * tensors[0].element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Fused ``silu(gate) * up`` (f32 inside, one rounding). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if gate.device.type == "cpu":
        return swiglu_reference(gate, up)
    _check("swiglu", gate, up)
    code = _build.dtype_code(gate.dtype)
    lib = _build.build()
    out = torch.empty_like(gate)
    rc = lib.swiglu_fwd(gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                        gate.numel(), code, int(_vec(gate, up, out)),
                        _build.stream_ptr(gate.device))
    _build.check(rc, "swiglu")
    swiglu.launches += 1
    return out


def swiglu_bwd_reference(gate: torch.Tensor, up: torch.Tensor,
                         grad: torch.Tensor):
    """Plain version of the backward kernel, in f32, each output rounded
    once: ``dgate = go*u*sig*(1 + g*(1 - sig))``, ``dup = go*g*sig``."""
    g, u, go = gate.float(), up.float(), grad.float()
    sig = torch.sigmoid(g)
    dgate = go * u * sig * (1 + g * (1 - sig))
    dup = go * (g * sig)
    return dgate.to(gate.dtype), dup.to(up.dtype)


def swiglu_bwd(gate: torch.Tensor, up: torch.Tensor, grad: torch.Tensor):
    """(dgate, dup) of ``silu(gate) * up`` for the output gradient
    ``grad``. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if gate.device.type == "cpu":
        return swiglu_bwd_reference(gate, up, grad)
    _check("swiglu_bwd", gate, up, grad)
    code = _build.dtype_code(gate.dtype)
    lib = _build.build()
    dgate, dup = torch.empty_like(gate), torch.empty_like(up)
    rc = lib.swiglu_bwd(gate.data_ptr(), up.data_ptr(), grad.data_ptr(),
                        dgate.data_ptr(), dup.data_ptr(), gate.numel(), code,
                        int(_vec(gate, up, grad, dgate, dup)),
                        _build.stream_ptr(gate.device))
    _build.check(rc, "swiglu_bwd")
    swiglu_bwd.launches += 1
    return dgate, dup


#: kernel launches since the last reset (chip_smoke.py reads and zeroes them)
swiglu.launches = 0
swiglu_bwd.launches = 0


class SwiGLUFunction(torch.autograd.Function):
    """``swiglu`` with its backward from the saved raw inputs."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return swiglu(gate, up)

    @staticmethod
    def backward(ctx, grad):
        gate, up = ctx.saved_tensors
        return swiglu_bwd(gate, up, grad.contiguous())
