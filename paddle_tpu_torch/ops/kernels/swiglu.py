"""SwiGLU forward: the CUDA kernel ``csrc/swiglu.cu`` and its plain
PyTorch version.

Port of ``paddle_tpu/ops/pallas/swiglu.py`` (``swiglu_reference``,
``_fwd_kernel``, ``_swiglu_fwd_impl``), forward only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["swiglu", "swiglu_reference"]


def swiglu_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain version: ``silu(gate) * up`` in the input dtype, exactly the
    unfused functional's math."""
    return F.silu(gate) * up


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Fused ``silu(gate) * up`` (f32 inside, one rounding). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if gate.device.type == "cpu":
        return swiglu_reference(gate, up)
    if gate.device.type != "cuda":
        raise RuntimeError(f"swiglu: no kernel for device {gate.device}")
    if (up.shape != gate.shape or up.dtype != gate.dtype
            or up.device != gate.device):
        raise ValueError(f"swiglu: gate {tuple(gate.shape)} {gate.dtype} "
                         f"and up {tuple(up.shape)} {up.dtype} differ")
    if not (gate.is_contiguous() and up.is_contiguous()):
        raise ValueError("swiglu: the kernel takes contiguous tensors")
    code = _build.dtype_code(gate.dtype)
    lib = _build.build()
    out = torch.empty_like(gate)
    n = gate.numel()
    vec = (n * gate.element_size() % 16 == 0
           and all(t.data_ptr() % 16 == 0 for t in (gate, up, out)))
    rc = lib.swiglu_fwd(gate.data_ptr(), up.data_ptr(), out.data_ptr(), n,
                        code, int(vec), _build.stream_ptr(gate.device))
    _build.check(rc, "swiglu")
    swiglu.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads and zeroes it)
swiglu.launches = 0
