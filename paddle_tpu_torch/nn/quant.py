"""Weight-only quantization for serving: the port of
``paddle_tpu/nn/quant/__init__.py``'s ``weight_quantize``, the int4
nibble packing, ``WeightOnlyLinear`` and ``quantize_for_serving``.

A projection's weight is quantized once, per output channel (absmax over
its inputs): int8 codes in [-127, 127] with ``scale = absmax / 127``, or
int4 codes in [-8, 7] with ``scale = absmax / 7``, two to a byte. The
codes and the f32 scales are buffers, not parameters. The forward casts
the codes to the activation dtype, multiplies (``torch.matmul``: cuBLAS
on the card, as XLA computes it in the JAX package) and scales the
product per output channel in f32. No kernel of the JAX package is
involved: it computes this in XLA, not Pallas.

The port stores codes as ``torch.nn.Linear`` stores weights, ``[out,
in]`` (int4: ``[out, ceil(in / 2)]``, even input in the low nibble), where
the JAX package stores ``[in, out]``; the codes and scales agree, the
bytes' layout need not. :func:`weight_quantize` keeps the JAX package's
signature (``[in, out]`` in, codes ``[in, out]`` out).
"""

from __future__ import annotations

import torch
from torch import nn

from ..profiler.metrics import get_registry

__all__ = ["weight_quantize", "pack_int4", "unpack_int4", "WeightOnlyLinear",
           "quantize_for_serving"]

#: absmax range and clip bounds of each algo: int8 symmetric (the
#: reference skips -128), int4 the full two's-complement [-8, 7]
_INT_RANGE = {"weight_only_int8": 127.0, "weight_only_int4": 7.0}
_INT_CLIP = {"weight_only_int8": (-127.0, 127.0),
             "weight_only_int4": (-8.0, 7.0)}

#: the projections the serving path quantizes (the JAX package's set;
#: GPT2's fused names included). Norms and embeddings stay as they are.
_QUANT_TARGETS = frozenset({
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "lm_head",
    "c_attn", "c_proj", "c_fc",
})


def _check_algo(algo):
    if algo not in _INT_RANGE:
        raise ValueError(f"unsupported serving weight_quant algo {algo!r} "
                         "(expected 'weight_only_int8' or "
                         "'weight_only_int4')")


def weight_quantize(x: torch.Tensor, algo="weight_only_int8"):
    """Per-out-channel absmax quantization of x [in, out] (float) ->
    (codes int8 [in, out], scale f32 [out]), with ``x ~= codes * scale``.
    Codes are ``clip(round(x / max(scale, 1e-8)))`` (``torch.round``
    rounds half to even, as ``jnp.round``)."""
    _check_algo(algo)
    lo, hi = _INT_CLIP[algo]
    wf = x.float()
    scale = wf.abs().amax(0) / _INT_RANGE[algo]
    q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-8)), lo, hi)
    return q.to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 codes in [-8, 7], int8 [out, in] -> nibble-packed int8 [out,
    ceil(in / 2)]: even input in the low nibble, odd in the high one (an
    odd ``in`` pads a zero column)."""
    q = q.to(torch.int32)
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    byte = (q[:, 0::2] & 0xF) | ((q[:, 1::2] & 0xF) << 4)
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(p: torch.Tensor, in_features: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: both nibbles sign-extended -> int8
    [out, in_features], in int8 arithmetic (the left shift wraps)."""
    lo = (p << 4) >> 4          # arithmetic: the sign of the low nibble
    hi = p >> 4                 # and of the high one
    return torch.stack((lo, hi), 2).reshape(p.shape[0], -1)[:, :in_features]


class WeightOnlyLinear(nn.Module):
    """Serving replacement for a projection: int8 (or nibble-packed int4)
    codes and per-out-channel f32 scales as buffers, and the forward
    ``(x @ codes.T) * scale (+ bias)`` in the activation dtype with the
    scale applied in f32. ``weight`` is ``[out, in]``, as
    ``torch.nn.Linear`` holds it. Inference only."""

    def __init__(self, weight: torch.Tensor, bias=None,
                 algo="weight_only_int8"):
        super().__init__()
        _check_algo(algo)
        self.algo = algo
        self.out_features, self.in_features = (int(n) for n in weight.shape)
        with torch.no_grad():
            q, s = weight_quantize(weight.detach().t(), algo)
            q = q.t().contiguous()
            if algo == "weight_only_int4":
                q = pack_int4(q)
            self.register_buffer("weight_q", q)
            self.register_buffer("weight_scale", s)
            self.register_buffer("bias", None if bias is None
                                 else bias.detach().clone())

    def codes(self) -> torch.Tensor:
        """The int8 codes [out, in] (int4 unpacked)."""
        if self.algo == "weight_only_int4":
            return unpack_int4(self.weight_q, self.in_features)
        return self.weight_q

    def forward(self, x):
        cd = x.dtype
        y = torch.matmul(x, self.codes().to(cd).t())
        y = (y.float() * self.weight_scale).to(cd)
        if self.bias is not None:
            y = y + self.bias.to(cd)
        return y

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"algo={self.algo}")


def _nbytes(t):
    return t.numel() * t.element_size()


def quantize_for_serving(model: nn.Module, algo=None, targets=None):
    """Replace the model's projections by :class:`WeightOnlyLinear` in
    place: every ``torch.nn.Linear`` child whose name is in ``targets``
    (default :data:`_QUANT_TARGETS`). ``algo`` defaults to
    ``model.config.weight_quant``; with none, nothing changes. Idempotent
    (a converted layer is no ``nn.Linear``); a tied-embedding model has
    no ``lm_head`` child, so its embedding stays full precision. Sets the
    ``quant/weight_layers``, ``quant/weight_bytes`` and
    ``quant/weight_bytes_saved`` gauges of the process registry and
    returns ``{"layers", "bytes", "bytes_saved"}`` of this call."""
    if algo is None:
        algo = getattr(getattr(model, "config", None), "weight_quant", None)
    if not algo:
        return {"layers": 0, "bytes": 0, "bytes_saved": 0}
    _check_algo(algo)
    names = frozenset(targets) if targets is not None else _QUANT_TARGETS
    converted = q_bytes = saved = 0
    for parent in list(model.modules()):
        for cname, child in list(parent.named_children()):
            if cname not in names or not isinstance(child, nn.Linear):
                continue
            wol = WeightOnlyLinear(child.weight, bias=child.bias, algo=algo)
            setattr(parent, cname, wol)
            new = _nbytes(wol.weight_q) + _nbytes(wol.weight_scale)
            converted += 1
            q_bytes += new
            saved += _nbytes(child.weight) - new
    reg = get_registry()
    reg.gauge("quant/weight_layers").set(converted)
    reg.gauge("quant/weight_bytes").set(q_bytes)
    reg.gauge("quant/weight_bytes_saved").set(saved)
    return {"layers": converted, "bytes": q_bytes, "bytes_saved": saved}
