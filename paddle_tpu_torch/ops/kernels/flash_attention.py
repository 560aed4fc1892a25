"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_attention.cu`` and their plain PyTorch versions, with the
autograd Function that joins them.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``: the forward
(``flash_attention_reference``, ``_fwd_kernel``/``_flash_fwd``) returns
the output and the row log-sum-exp; the backward kernels
(``_dkv_kernel``, ``_dq_kernel``/``_flash_bwd_pallas``) recompute the
probabilities from it, with ``delta = rowsum(dO * O)`` in f32. The plain
backward is the port of ``_bwd_rule_scan``.

Layouts (as in the JAX package): q, out [B, Sq, H, D]; k, v [B, Sk, KVH,
D] with KVH dividing H (query head h reads kv head h // (H // KVH)); lse
and delta [B, H, Sq] in f32. Causal masking is bottom-right aligned: key
j is visible to query i iff ``j <= i + Sk - Sq``. A row with no visible
key has output 0 and zero gradients.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention", "FlashAttentionFunction",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_dkv", "flash_attention_dkv_reference",
           "flash_attention_dq", "flash_attention_dq_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference"]

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
# keys per step of the plain backward (the JAX scan's block)
_SCAN_BLOCK = 512


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _visible(sq, k_pos, sk, causal, device):
    """[Sq, len(k_pos)] bool: which keys each query row may see."""
    if not causal:
        return torch.ones(sq, len(k_pos), dtype=torch.bool, device=device)
    q_pos = torch.arange(sq, device=device)[:, None]
    return k_pos[None, :] <= q_pos + (sk - sq)


def _heads(t, rep):
    """[B, S, KVH, D] -> [B, H, S, D] f32, kv heads repeated."""
    if rep != 1:
        t = t.repeat_interleave(rep, dim=2)
    return t.transpose(1, 2).float()


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """Plain forward: f32 logits, softmax in f32, probabilities cast to
    v's dtype before P.V (as ``flash_attention_reference``); masked
    probabilities are 0, so a row with no visible key gives 0. Returns
    (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32)."""
    sq, h = q.shape[1], q.shape[2]
    sk, kvh = k.shape[1], k.shape[2]
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(),
                          _heads(k, h // kvh)) * _scale(q, scale)
    valid = _visible(sq, torch.arange(sk, device=q.device), sk, causal,
                     q.device)
    logits = logits.masked_fill(~valid, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
    vh = v.repeat_interleave(h // kvh, dim=2) if h != kvh else v
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vh)
    return out.to(q.dtype), lse


def _bwd_scan(q, k, v, grad, lse, delta, causal, scale, want_dq,
              want_dkv):
    """The port of ``_bwd_rule_scan``: f32 throughout, keys in blocks of
    512, probabilities recomputed from lse and masked explicitly (a row
    with no visible key has lse ~ -1e30, where exp(s - lse) would be
    1). Returns (dq or None, dk or None, dv or None)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    s = _scale(q, scale)
    qh, gh = q.transpose(1, 2).float(), grad.transpose(1, 2).float()
    kh, vh = _heads(k, rep), _heads(v, rep)
    dq = torch.zeros_like(qh) if want_dq else None
    dk = torch.empty_like(kh) if want_dkv else None
    dv = torch.empty_like(vh) if want_dkv else None
    for k0 in range(0, sk, _SCAN_BLOCK):
        ks, vs = kh[:, :, k0:k0 + _SCAN_BLOCK], vh[:, :, k0:k0 + _SCAN_BLOCK]
        k_pos = torch.arange(k0, k0 + ks.shape[2], device=q.device)
        valid = _visible(sq, k_pos, sk, causal, q.device)
        logits = (qh @ ks.transpose(-1, -2)) * s
        p = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
        ds = p * (gh @ vs.transpose(-1, -2) - delta[..., None]) * s
        if want_dq:
            dq += ds @ ks
        if want_dkv:
            dv[:, :, k0:k0 + _SCAN_BLOCK] = p.transpose(-1, -2) @ gh
            dk[:, :, k0:k0 + _SCAN_BLOCK] = ds.transpose(-1, -2) @ qh
    if want_dq:
        dq = dq.transpose(1, 2).to(q.dtype)
    if want_dkv:
        # sum over the query heads that share a kv head
        dk = dk.reshape(b, kvh, rep, sk, d).sum(2).transpose(1, 2)
        dv = dv.reshape(b, kvh, rep, sk, d).sum(2).transpose(1, 2)
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


def flash_attention_dkv_reference(q, k, v, grad, lse, delta, causal=False,
                                  scale=None):
    """Plain version of the dkv kernel: (dk, dv) in k's and v's dtypes."""
    _, dk, dv = _bwd_scan(q, k, v, grad, lse, delta, causal, scale, False,
                          True)
    return dk, dv


def flash_attention_dq_reference(q, k, v, grad, lse, delta, causal=False,
                                 scale=None):
    """Plain version of the dq kernel: dq in q's dtype."""
    return _bwd_scan(q, k, v, grad, lse, delta, causal, scale, True,
                     False)[0]


def _delta(out, grad):
    """rowsum(dO * O) in f32, [B, H, Sq]."""
    return (grad.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, grad, causal=False,
                                  scale=None):
    """The plain backward (``_bwd_rule_scan``): (dq, dk, dv)."""
    return _bwd_scan(q, k, v, grad, lse, _delta(out, grad), causal, scale,
                     True, True)


def _check(name, q, k, v, *more):
    """Raise unless the kernels take these tensors. ``more`` holds
    (tensor, shape, dtype) triples for the other inputs."""
    if q.device.type != "cuda":
        raise _build.KernelError(f"{name}: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, S, heads, D]")
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh \
            or d not in _HEAD_DIMS:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} not taken (same B and D, KVH "
                         f"dividing H, D in {_HEAD_DIMS})")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    for t, shape, dtype in more:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} where "
                             f"{tuple(shape)} {dtype} was expected")
    tensors = (q, k, v) + tuple(t for t, _, _ in more)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the kernel reads 16-byte vectors; the "
                         f"inputs must be aligned")
    return b, sq, k.shape[1], h, kvh, d, _build.dtype_code(q.dtype)


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(out, lse). A CPU tensor takes the plain version; a CUDA tensor
    launches the forward kernel (one CTA per q block, batch and q head)
    or raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    b, sq, sk, h, kvh, d, code = _check("flash_attention_fwd", q, k, v)
    lib = _build.build()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, kvh, d, float(_scale(q, scale)),
        int(causal), code, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _bwd_check(name, q, k, v, grad, lse, delta):
    b, sq, h = q.shape[:3]
    f32 = torch.float32
    return _check(name, q, k, v, (grad, q.shape, q.dtype),
                  (lse, (b, h, sq), f32), (delta, (b, h, sq), f32))


def flash_attention_dkv(q, k, v, grad, lse, delta, causal=False,
                        scale=None):
    """(dk, dv). A CPU tensor takes the plain version; a CUDA tensor
    launches the dkv kernel (one CTA per kv block, batch and kv head) or
    raises."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, grad, lse, delta,
                                             causal, scale)
    b, sq, sk, h, kvh, d, code = _bwd_check("flash_attention_dkv", q, k, v,
                                            grad, lse, delta)
    lib = _build.build()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        sq, sk, h, kvh, d, float(_scale(q, scale)), int(causal), code,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_dq(q, k, v, grad, lse, delta, causal=False,
                       scale=None):
    """dq. A CPU tensor takes the plain version; a CUDA tensor launches
    the dq kernel (one CTA per q block, batch and q head) or raises."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, grad, lse, delta,
                                            causal, scale)
    b, sq, sk, h, kvh, d, code = _bwd_check("flash_attention_dq", q, k, v,
                                            grad, lse, delta)
    lib = _build.build()
    dq = torch.empty_like(q)
    rc = lib.flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, sk, h, kvh,
        d, float(_scale(q, scale)), int(causal), code,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, out, lse, grad, causal=False, scale=None):
    """(dq, dk, dv) from the forward's saved output and lse: delta is a
    plain f32 reduction (the JAX package computes it outside the kernels
    too), then the dkv and dq kernels (or their plain versions)."""
    delta = _delta(out, grad)
    dk, dv = flash_attention_dkv(q, k, v, grad, lse, delta, causal, scale)
    dq = flash_attention_dq(q, k, v, grad, lse, delta, causal, scale)
    return dq, dk, dv


#: kernel launches since the last reset (chip_smoke.py reads and zeroes them)
flash_attention_fwd.launches = 0
flash_attention_dkv.launches = 0
flash_attention_dq.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward kernels; saves q, k, v, the
    output and lse (O(S*D) memory, no S x S matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         grad.contiguous(), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Attention over [B, S, H, D] q and [B, S, KVH, D] k/v, differentiable
    through :class:`FlashAttentionFunction`."""
    return FlashAttentionFunction.apply(q, k, v, causal, scale)
