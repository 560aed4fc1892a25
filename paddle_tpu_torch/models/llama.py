"""Llama for training and for serving over paged KV pools.

Port of ``paddle_tpu/models/llama.py``: ``LlamaConfig`` (the ``tiny``,
``llama_1b`` and ``llama3_8b`` presets), the dense training path and the
cache path of ``LlamaAttention``/``LlamaMLP``/``LlamaDecoderLayer``/
``LlamaModel``/``LlamaForCausalLM``, ``LlamaPretrainingCriterion``,
``rope_with_offset`` and ``_paged_attention_step`` (bf16/f32 pools).

Training (no caches): ``model(ids, labels=ids)`` returns ``(logits,
loss)``, the shifted next-token cross entropy, and ``loss.backward()``
runs torch autograd through the kernels' ``autograd.Function``s
(RMSNorm, SwiGLU, flash attention). The configuration ported is the JAX
package's unfused one: each residual add in the input dtype followed by
its own RMSNorm (``FLAGS_fused_rmsnorm_residual`` off), the loss over
full logits (``FLAGS_fused_linear_cross_entropy`` off) and no recompute.
The fused residual carry, fused linear+CE and recompute are not ported
yet, and the config has no switch for them.

Attribute names match the JAX package, so the state-dict keys do
(``llama.layers.0.self_attn.q_proj.weight``, ...); ``torch.nn.Linear``
holds its weight as [out, in] where Paddle holds [in, out], which
``paddle_tpu_torch.convert`` accounts for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import RMSNorm
from ..nn import functional as F
from ..ops import paged_attention as PA
from ..ops.rope import build_sin_cos, rotate

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "rope_with_offset"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    intermediate_size: int = 14336
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False

    @classmethod
    def llama3_8b(cls):
        return cls()

    @classmethod
    def llama_1b(cls):
        return cls(vocab_size=32000, hidden_size=2048,
                   num_hidden_layers=16, num_attention_heads=16,
                   num_key_value_heads=8, intermediate_size=5632,
                   max_position_embeddings=4096, rope_theta=10000.0)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   intermediate_size=128, max_position_embeddings=128,
                   rope_theta=10000.0)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def rope_with_offset(sin_tab, cos_tab, pos, seq_len):
    """Per-token (sin, cos) [B, S, D/2] at absolute positions
    ``pos + [0..S)``. Positions past the table (chunk padding near
    ``max_position_embeddings``) are clamped onto its last row: their
    tokens are padding, whose writes go to the trash page and whose
    outputs are zeroed, and an index past the end would fault on the
    device (the JAX package's ``jnp.take`` returns NaN there instead)."""
    pid = pos.long()[:, None] + torch.arange(seq_len, device=pos.device)
    pid = pid.clamp_(max=sin_tab.shape[0] - 1)
    return sin_tab[pid], cos_tab[pid]


def _paged_attention_step(attn, q, k, v, cache, ctx, tables, rope):
    """Continuous-batching attention over the paged pools: rotate q/k,
    write the chunk's k/v into the slot pages at ``ctx .. ctx + valid - 1``
    (padding and idle slots to trash page 0; in place), then attend
    through :func:`ops.paged_attention.ragged_paged_attention` (prefill
    chunk, decode step or idle slot alike). ``tables`` is
    ``(block_tables, valid)``, both int32."""
    b, s = q.shape[0], q.shape[1]
    tbl, valid = tables
    sin, cos = rope
    q = rotate(q, sin, cos)
    k = rotate(k, sin, cos)
    PA.paged_prefill_write(cache[0], cache[1], k, v, tbl, ctx, valid)
    out = PA.ragged_paged_attention(q, cache[0], cache[1], tbl, ctx, valid)
    return attn.o_proj(out.reshape(b, s, attn.num_heads * attn.head_dim))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        h, d = cfg.hidden_size, self.head_dim
        self.q_proj = nn.Linear(h, self.num_heads * d, **kw)
        self.k_proj = nn.Linear(h, self.num_kv_heads * d, **kw)
        self.v_proj = nn.Linear(h, self.num_kv_heads * d, **kw)
        self.o_proj = nn.Linear(self.num_heads * d, h, **kw)

    def forward(self, x, rope, cache=None, ctx=None, tables=None):
        """Without a cache: causal attention over the sequence (the
        training path: RoPE at positions 0..S-1, flash attention).
        With one: a paged serving step."""
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        if cache is not None:
            return _paged_attention_step(self, q, k, v, cache, ctx, tables,
                                         rope)
        sin, cos = rope
        out = F.scaled_dot_product_attention(rotate(q, sin, cos),
                                             rotate(k, sin, cos), v,
                                             is_causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, i, **kw)
        self.up_proj = nn.Linear(h, i, **kw)
        self.down_proj = nn.Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.mlp = LlamaMLP(cfg, device, dtype)

    def forward(self, x, rope, cache=None, ctx=None, tables=None):
        """The unfused stack: each residual add in the input dtype, then
        its own RMSNorm."""
        x = x + self.self_attn(self.input_layernorm(x), rope, cache, ctx,
                               tables)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, device=device,
                                         dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)
        # RoPE tables: derived, not weights, so outside the state dict
        self.register_buffer("rope_sin", torch.empty(
            config.max_position_embeddings, config.head_dim // 2,
            device=device), persistent=False)
        self.register_buffer("rope_cos", torch.empty_like(self.rope_sin),
                             persistent=False)

    def reset_rope(self):
        sin, cos = build_sin_cos(self.config.max_position_embeddings,
                                 self.config.head_dim,
                                 self.config.rope_theta,
                                 device=self.rope_sin.device)
        self.rope_sin.copy_(sin)
        self.rope_cos.copy_(cos)

    def forward(self, input_ids, caches=None, pos=None, tables=None):
        """input_ids [B, S]. Without caches: the final hidden states [B, S,
        H] of the training path. With them, a serving step returning
        ``(hidden, caches)``: caches are the flat [k0, v0, k1, v1, ...]
        pools, written in place; pos [B] or [B, 1] cache lengths before
        the chunk; tables ``(block_tables [B, pages], valid)`` where valid
        is an int count per slot or a bool active mask."""
        b, s = input_ids.shape
        x = self.embed_tokens(input_ids)
        if caches is None:
            rope = (self.rope_sin[None, :s], self.rope_cos[None, :s])
            for layer in self.layers:
                x = layer(x, rope)
            return self.norm(x)
        ctx = pos.reshape(b).to(torch.int32)
        tbl, gate = tables
        tables = (tbl.to(torch.int32), gate.to(torch.int32))
        rope = rope_with_offset(self.rope_sin, self.rope_cos, ctx, s)
        for i, layer in enumerate(self.layers):
            x = layer(x, rope, caches[2 * i:2 * i + 2], ctx, tables)
        return self.norm(x), caches


class LlamaForCausalLM(nn.Module):
    """Causal LM. Built on ``device`` (``cuda`` unless given; raises with
    no GPU and no device) in ``dtype``, with weights drawn from
    ``torch.Generator`` seeded by ``seed``: N(0, initializer_range) for
    projections and embeddings, ones for norms."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        # built on the meta device, then materialised once: no throwaway
        # default initialisation of billions of weights
        self.llama = LlamaModel(config, device="meta", dtype=dtype)
        self.lm_head = None if config.tie_word_embeddings else nn.Linear(
            config.hidden_size, config.vocab_size, bias=False,
            device="meta", dtype=dtype)
        self.to_empty(device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        dev = self.llama.embed_tokens.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        std = self.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        self.llama.reset_rope()

    def _logits(self, hidden):
        weight = self.llama.embed_tokens.weight if self.lm_head is None \
            else self.lm_head.weight
        return torch.nn.functional.linear(hidden, weight)

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                tables=None):
        """The JAX package's signature. With ``caches``: a serving step,
        ``(logits [B, S, V], caches)`` with the pools updated in place
        (no autograd: the in-place pool writes must not join a graph).
        Without: the training forward, ``logits`` or, given ``labels``,
        ``(logits, loss)`` with the loss over ``logits[:, :-1]`` against
        ``labels[:, 1:]``."""
        if caches is not None:
            with torch.no_grad():
                hidden, caches = self.llama(input_ids, caches, pos, tables)
                return self._logits(hidden), caches
        logits = self._logits(self.llama(input_ids))
        if labels is None:
            return logits
        return logits, _shifted_cross_entropy(logits, labels)


def _shifted_cross_entropy(logits, labels):
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                           labels[:, 1:].reshape(-1))


class LlamaPretrainingCriterion(nn.Module):
    """Shifted next-token cross entropy: ``criterion(model(ids), ids)``
    equals the loss of ``model(ids, labels=ids)``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.vocab_size = config.vocab_size

    def forward(self, logits, labels):
        return _shifted_cross_entropy(logits, labels)
