"""Cost accounting: FLOPs and bytes per section from static shapes.

Port of ``paddle_tpu/profiler/cost.py``, with the same FLOP and byte
counts. It gives every trace span and breakdown row its denominator: the
section's MFU (achieved over peak FLOP/s) and a roofline classification
(compute- or memory-bound from the arithmetic intensity against the
card's ridge point).

Accounting conventions (the JAX package's):

- MFU counts MODEL FLOPs. Recompute's re-forward work is real hardware
  time but is NOT added to the FLOPs (that would report HFU), so configs
  that recompute much show a lower MFU than the hardware's busy share.
- Train steps count 3x the forward matmul FLOPs (1 forward + 2
  forward-equivalents of backward), the 6·N·tokens convention.
- Byte counts are algorithm-level (operands read once, the result
  written once); they bound the roofline, they do not model cache reuse.

The peaks are the card's (``device_peaks``), matched on
``torch.cuda.get_device_name``; an unknown device gets the fallback, as
in the JAX package. Standard library only at import time.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SectionCost", "Peaks", "device_peaks", "peak_flops",
           "matmul_cost", "attention_cost", "grouped_matmul_cost",
           "transformer_step_flops", "moe_section_costs", "mfu",
           "roofline", "rms_norm_cost", "swiglu_cost",
           "fused_linear_ce_cost"]

@dataclass
class SectionCost:
    """FLOPs + bytes attributed to one program section."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "SectionCost") -> "SectionCost":
        return SectionCost(self.flops + other.flops,
                           self.bytes + other.bytes)

    def __mul__(self, k) -> "SectionCost":
        return SectionCost(self.flops * k, self.bytes * k)

    __rmul__ = __mul__

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes}


@dataclass
class Peaks:
    """Per-chip peaks: bf16 matmul FLOP/s and HBM bandwidth (B/s)."""

    flops: float
    hbm_bw: float
    kind: str = "unknown"

    @property
    def ridge(self) -> float:
        """Arithmetic intensity (FLOPs/byte) where the chip turns
        compute-bound."""
        return self.flops / self.hbm_bw


# Dense bf16 tensor-core FLOP/s and HBM bytes/s: the NVIDIA H100 SXM5
# spec sheet's figures (989.4 TFLOP/s without sparsity, 3.35 TB/s). The
# SXM5 card names itself "NVIDIA H100 80GB HBM3"; other cards take the
# fallback (keys matched in order, on the lower-cased name).
H100_SXM = Peaks(989.4e12, 3.35e12, "h100-sxm")
_PEAK_TABLE = (
    ("h100 80gb hbm3", H100_SXM),
    ("h100 sxm", H100_SXM),
)
_FALLBACK = Peaks(50e12, 100e9, "unknown")   # CPU/unknown: line still prints


def _device_name(device):
    """The card's name for ``device``: an object with ``device_kind`` (a
    name, as the JAX package's devices carry), a CUDA ``torch.device``,
    index or string, or None for the first card; None without a card."""
    kind = getattr(device, "device_kind", None)
    if kind is not None:
        return str(kind)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = 0
    dev = torch.device(device) if not isinstance(device, int) else \
        torch.device("cuda", device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev)


def device_peaks(device=None) -> Peaks:
    """Peaks of ``device`` (default: the first CUDA card). Unknown
    devices (CPU runs) get a fallback so records still emit."""
    name = _device_name(device)
    kind = (name or "").lower()
    for key, peaks in _PEAK_TABLE:
        if key in kind:
            return peaks
    return _FALLBACK


def peak_flops(device=None) -> float:
    return device_peaks(device).flops


def matmul_cost(m, k, n, *, batch=1, dtype_bytes=2) -> SectionCost:
    """[m, k] @ [k, n] (optionally batched): 2mkn FLOPs, operands read
    once + result written once."""
    return SectionCost(
        flops=2.0 * batch * m * k * n,
        bytes=float(batch) * dtype_bytes * (m * k + k * n + m * n))


def grouped_matmul_cost(rows, d, h, num_experts, *,
                        dtype_bytes=2) -> SectionCost:
    """Grouped matmul over an [E, d, h] bank: ``rows`` total row-tiles
    worth of tokens, each contracting [d] -> [h]. The whole weight bank
    streams once per call (the kernel revisits no expert's weights), not
    once per tile."""
    return SectionCost(
        flops=2.0 * rows * d * h,
        bytes=dtype_bytes * (rows * d + num_experts * d * h + rows * h))


def attention_cost(batch, q_len, heads, head_dim, kv_len=None, *,
                   causal=True, dtype_bytes=2) -> SectionCost:
    """QK^T + AV FLOPs (the 12·L·B·S²·d convention divides the same
    way: 4·B·H·S·S_kv·dh per layer, halved when causal masking skips
    the upper triangle)."""
    kv_len = q_len if kv_len is None else kv_len
    f = 4.0 * batch * heads * q_len * kv_len * head_dim
    if causal and kv_len == q_len:
        f *= 0.5
    b = dtype_bytes * batch * heads * (q_len + 2 * kv_len + q_len) \
        * head_dim
    return SectionCost(flops=f, bytes=float(b))


def transformer_step_flops(n_params, tokens, num_layers, batch, seq,
                           hidden) -> float:
    """Train-step model FLOPs: 6·N·tokens + the S² attention term —
    the formula of the JAX bench's MFU headline."""
    return 6.0 * n_params * tokens + 12.0 * num_layers * batch \
        * seq * seq * hidden


def moe_section_costs(tokens, d_model, d_hidden, num_experts, top_k, *,
                      num_moe_layers=1, capacity_factor=None,
                      dropless=True, bm=128, train=True,
                      dtype_bytes=2) -> dict:
    """Per-section costs for one MoE step's sparse-FFN stack —
    the denominators of the gating / sort / a2a / expert-matmul
    breakdown (the JAX package's profiler.breakdown, ROADMAP A.6).

    ``rows`` is the number of expert-FFN input rows the hardware
    actually executes: tokens·k (+ <= E·bm tile padding) for dropless,
    capacity_factor·tokens·k for the capacity formulation (its padding
    is executed work). ``train=True`` multiplies matmul FLOPs by 3
    (fwd + 2x bwd); remat re-forwards are deliberately NOT counted
    (module docstring)."""
    T, d, h, E, k = tokens, d_model, d_hidden, num_experts, top_k
    if dropless:
        rows = T * k + E * bm // 2          # expected tile padding
    else:
        cf = 1.25 if capacity_factor is None else float(capacity_factor)
        rows = int(cf * T * k)
    mult = 3.0 if train else 1.0
    gating = matmul_cost(T, d, E, dtype_bytes=4) * mult      # fp32 router
    # sort/dispatch: index math is negligible FLOPs; the cost is moving
    # every routed row in and out of the expert layout (two gathers)
    sort = SectionCost(flops=0.0,
                       bytes=2.0 * rows * d * dtype_bytes * mult)
    expert = (grouped_matmul_cost(rows, d, h, E, dtype_bytes=dtype_bytes)
              * 2 +                                         # gate + up
              grouped_matmul_cost(rows, h, d, E,
                                  dtype_bytes=dtype_bytes)) * mult
    a2a = SectionCost(flops=0.0,
                      bytes=2.0 * rows * d * dtype_bytes * mult)
    L = num_moe_layers
    return {"gating": gating * L, "sort": sort * L,
            "expert_matmul": expert * L, "a2a": a2a * L}


def rms_norm_cost(n, d, *, residual=False, train=False,
                  dtype_bytes=2) -> SectionCost:
    """(Residual-)RMSNorm over ``n`` rows of ``d``: ~4 elementwise ops
    per element fwd (square, reduce, rsqrt-scale, weight mul; +1 for the
    fused residual add). Bytes are the fused kernel's streams — each
    input read once, each output written once (the residual variant
    reads x+res and writes y+r: four streams, not six — exactly the
    traffic the fusion saves vs an unfused add + norm). ``train``
    multiplies both by 3 (dh kernel + dw reduction ~ 2 fwd-equiv)."""
    ops = 5.0 if residual else 4.0
    streams = 4.0 if residual else 2.0
    c = SectionCost(
        flops=ops * n * d,
        bytes=float(dtype_bytes) * (streams * n * d + d))
    return c * 3 if train else c


def swiglu_cost(n, h, *, train=False, dtype_bytes=2) -> SectionCost:
    """Fused SwiGLU over ``n`` rows of ``h``: ~6 elementwise ops per element
    fwd (sigmoid ~4 + 2 muls), 3 streams (gate, up in; out). The bwd
    kernel recomputes sigmoid and writes dgate/dup: ~2x fwd work over
    5 streams — folded into the x3 train multiplier like every
    estimator here."""
    c = SectionCost(flops=6.0 * n * h,
                    bytes=float(dtype_bytes) * 3.0 * n * h)
    return c * 3 if train else c


def fused_linear_ce_cost(n, d, v, *, train=False,
                         dtype_bytes=2) -> SectionCost:
    """Chunked fused linear+cross-entropy: the lm_head matmul
    ``[n, d] @ [d, v]`` dominates (2ndv FLOPs; softmax/gather work is
    O(nv) elementwise ops on top). Bytes NEVER include an [n, v] logits tensor
    — that is the point of the op: h and w stream once, the residents
    are [n]-vectors plus one f32 [n, d] dh accumulator in backward.
    ``train`` multiplies by 3 (model-FLOPs convention; the backward's
    logits re-matmul is remat-class recompute and deliberately NOT
    counted — module docstring)."""
    c = SectionCost(
        flops=2.0 * n * d * v + 4.0 * n * v,
        bytes=float(dtype_bytes) * (n * d + d * v)
        + 4.0 * 4.0 * n)           # f32 lse/max/sum/target vectors
    return c * 3 if train else c


def mfu(flops, seconds, peak=None, device=None) -> float:
    """Model-FLOPs utilization: flops / seconds / peak."""
    if peak is None:
        peak = device_peaks(device).flops
    if not seconds or not peak:
        return 0.0
    return flops / seconds / peak


def roofline(flops, bytes_, peaks: Peaks | None = None,
             device=None) -> dict:
    """Classify a section against the chip roofline. Returns arithmetic
    intensity, the ridge point, the bound ('compute' | 'memory'), and
    the attainable FLOP/s ceiling at this intensity."""
    if peaks is None:
        peaks = device_peaks(device)
    if not bytes_:
        return {"intensity": float("inf"), "ridge": peaks.ridge,
                "bound": "compute", "attainable_flops_per_s": peaks.flops}
    intensity = flops / bytes_
    bound = "compute" if intensity >= peaks.ridge else "memory"
    return {"intensity": intensity, "ridge": peaks.ridge, "bound": bound,
            "attainable_flops_per_s": min(peaks.flops,
                                          peaks.hbm_bw * intensity)}
