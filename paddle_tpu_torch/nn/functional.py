"""Functional forms on the serving and training paths.

Ports of ``paddle_tpu/nn/functional/norm.py::rms_norm`` and
``::fused_rms_norm_residual``, ``activation.py::swiglu``,
``attention.py::scaled_dot_product_attention`` (with ``sdpa_reference``,
the JAX package's non-kernel path), ``attention.py::sdpa_with_cache``
(the dense KV cache of ``generate``, plain ops as the JAX package's XLA
ones), ``common.py::linear`` and ``loss.py::cross_entropy`` (hard labels
and the mean, what the model uses), and the plain ops of GPT-2 and
ERNIE: ``norm.py::layer_norm``, ``activation.py::gelu`` and ``::tanh``,
``common.py::dropout``. Dropout (here and in the attention's
probabilities) draws its mask from an explicit ``torch.Generator``, so
its streams differ from the JAX package's ``jax.random`` ones by design;
the kept share and the ``1 / (1 - p)`` scale are the JAX package's.
``linear`` and ``scaled_dot_product_attention`` cast their matmul
operands under ``amp.auto_cast``, where the JAX package casts them.
Where the JAX package chose the Pallas kernel by backend and flags, the
port's kernel wrappers choose by the device of the tensor: CUDA launches
the kernel, the CPU takes the plain version. Gradients are torch
autograd, through the kernels' ``autograd.Function``s.
"""

from __future__ import annotations

import math

import torch

from ..amp.auto_cast import maybe_cast_matmul
from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import rms_norm as _rms
from ..ops.kernels import swiglu as _sw

__all__ = ["linear", "rms_norm", "fused_rms_norm_residual", "swiglu",
           "layer_norm", "gelu", "tanh", "dropout",
           "scaled_dot_product_attention", "sdpa_reference",
           "sdpa_with_cache", "cross_entropy"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)``, the weight in torch's [out, in] layout;
    under ``amp.auto_cast`` x and the weight in the AMP dtype (the bias
    is cast to the product's dtype, as the JAX package adds it)."""
    x, weight = maybe_cast_matmul(x, weight)
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return torch.nn.functional.linear(x, weight, bias)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)).to(x.dtype) * weight``."""
    return _rms.RMSNormFunction.apply(x, weight, epsilon)


def fused_rms_norm_residual(x: torch.Tensor, residual: torch.Tensor,
                            weight: torch.Tensor, epsilon: float = 1e-6):
    """``(rms_norm(x + residual) * weight, x + residual)`` as one op, the
    add in the input dtype: the decoder layer's residual add and the
    RMSNorm after it (K3 forward, K4 backward). Inputs of two dtypes (a
    bf16 projection onto an f32 stream under ``amp.auto_cast``) are
    promoted first, as ``x + residual`` promotes them."""
    if x.dtype != residual.dtype:
        dt = torch.promote_types(x.dtype, residual.dtype)
        x, residual = x.to(dt), residual.to(dt)
    return _rms.RMSNormResidualFunction.apply(x, residual, weight, epsilon)


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y``."""
    return _sw.SwiGLUFunction.apply(x, y)


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """The JAX package's rule: mean and variance over the last
    ``normalized_shape`` dims in f32, the normalised value cast to x's
    dtype, and only then times ``weight`` and plus ``bias``
    (``torch.nn.functional.layer_norm`` rounds once, after the affine,
    which in bf16 gives other bits). Plain PyTorch: the JAX package has
    no LayerNorm kernel."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: the exact erf form, or the tanh form with ``approximate``
    (GPT-2's)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """``x * keep / (1 - p)`` with ``keep`` Bernoulli(1 - p) in x's dtype,
    drawn from ``generator`` (on x's device; None takes torch's default
    one); x itself when not training or ``p`` is 0."""
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def sdpa_reference(q, k, v, attn_mask=None, dropout_p=0.0,
                   is_causal=False, generator=None):
    """Plain attention on [B, S, H, D]: kv heads repeated, logits in the
    input dtype, softmax in f32, probabilities cast to v's dtype. A bool
    mask keeps where True; any other mask is added to the logits. With
    ``dropout_p`` the probabilities go through :func:`dropout`, drawing
    from ``generator``."""
    s = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[2] != q.shape[2]:
        k, v = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2])
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)) * s
    # a fill, not a host tensor: no copy to the device (generate's
    # eos-less loop makes no host synchronisation)
    neg = torch.full((), -1e30, dtype=logits.dtype, device=logits.device)
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, neg)
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    probs = dropout(probs, dropout_p, True, generator)
    return (probs @ vh).transpose(1, 2)


def _repeat_kv(t, heads):
    """[B, S, KVH, D] -> [B, S, heads, D], each kv head repeated
    ``heads // KVH`` times in place (``repeat_interleave`` by a view)."""
    b, s, kvh, d = t.shape
    return t[:, :, :, None].expand(b, s, kvh, heads // kvh, d).reshape(
        b, s, heads, d)


def sdpa_with_cache(query, key, value, k_cache, v_cache, pos):
    """Attention of ``generate`` over a dense KV cache.

    Writes the new ``key``/``value`` [B, S, KVH, D] into ``k_cache``/
    ``v_cache`` [B, max_len, KVH, D] at sequence offset ``pos`` (an int or
    a 0-d integer tensor on the caches' device; the write starts at
    ``pos`` clamped to ``max_len - S``, as ``lax.dynamic_update_slice``
    does), **in place** and outside autograd, as the engine writes its
    paged pools; then attends ``query`` [B, S, H, D] over the whole cache
    with the mask ``cache_index <= pos + query_index``
    (:func:`sdpa_reference`: kv heads repeated, logits in the input dtype,
    softmax in f32). Prefill (``pos`` 0, S the prompt) and decode (S 1)
    alike. Returns ``(out, k_cache, v_cache)``."""
    s, max_len = query.shape[1], k_cache.shape[1]
    dev = query.device
    rows = torch.arange(s, device=dev)
    start = pos.clamp(0, max_len - s) if isinstance(pos, torch.Tensor) \
        else min(max(int(pos), 0), max_len - s)
    with torch.no_grad():
        k_cache.index_copy_(1, start + rows, key.to(k_cache.dtype))
        v_cache.index_copy_(1, start + rows, value.to(v_cache.dtype))
    mask = torch.arange(max_len, device=dev)[None, :] \
        <= pos + rows[:, None]                             # [S, max_len]
    out = sdpa_reference(query, k_cache.to(query.dtype),
                         v_cache.to(query.dtype), attn_mask=mask[None, None])
    return out, k_cache, v_cache


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Inputs and output [batch, seq, heads, head_dim]. With no mask, no
    dropout and equal query and key lengths this is flash attention (the
    kernels, causal or not); otherwise the plain :func:`sdpa_reference`
    (dropout live only when ``training``, drawing from ``generator``), as
    the JAX package routes. Under ``amp.auto_cast`` q, k and v are cast
    to the AMP dtype first."""
    query, key, value = maybe_cast_matmul(query, key, value)
    if (attn_mask is None and dropout_p == 0.0
            and query.shape[1] == key.shape[1]):
        return _fa.flash_attention(query, key, value, causal=is_causal)
    return sdpa_reference(query, key, value, attn_mask,
                          dropout_p if training else 0.0, is_causal,
                          generator)


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Hard-label cross entropy over the last dim of ``input``, log-softmax
    in f32, the mean over the rows not labelled ``ignore_index`` (0 when
    there are none)."""
    lf = torch.log_softmax(input.float(), dim=-1)
    idx = label.long()
    mask = idx != ignore_index
    safe = torch.where(mask, idx, 0)
    loss = -lf.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(mask, loss, 0.0)
    return loss.sum() / mask.sum().clamp(min=1).float()
