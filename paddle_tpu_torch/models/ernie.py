"""The ERNIE encoder family: pretraining, masked LM and sequence
classification.

Port of ``paddle_tpu/models/ernie.py``: ``ErnieConfig`` (``base``, the
ERNIE-3.0-base shape, and ``tiny``), ``ErnieEmbeddings`` (word, position,
token-type and task-type tables, LayerNorm, dropout), the post-norm
``ErnieLayer``, ``ErnieModel`` (its pooler ``tanh(pooler(x[:, 0]))``),
``ErnieForPretraining`` (the MLM decoder tied to the word embeddings
plus ``mlm_bias``, and the sentence-order head), ``ErnieForMaskedLM`` and
``ErnieForSequenceClassification``. Labels of -100 are ignored.

Attention is bidirectional, through ``nn.functional.
scaled_dot_product_attention``: with no ``attention_mask`` and dropout 0
the non-causal flash kernels (K7-K9); a padding mask (additive -1e30 over
[B, 1, 1, S]) or live attention dropout takes the plain path, as the JAX
package routes. LayerNorm and GELU (the exact form) are plain PyTorch.
Dropout draws from the model's ``torch.Generator`` (``dropout_seed``),
so its masks differ from the JAX package's by design. The stack is
unrolled (the JAX package's ``scan_layers`` gives the same numbers).

The state-dict keys are the JAX package's: ``ErnieForPretraining`` lists
``mlm_bias`` first, and ``ErnieForMaskedLM`` holds its encoder once,
under ``_pre.ernie`` (``ernie`` is a view of it, not a second module).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import Dropout, LayerNorm, Linear
from ..nn import functional as F
from .gpt2 import reset_dense_parameters, split_heads

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieForMaskedLM"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 3
    use_task_id: bool = True
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0

    @classmethod
    def base(cls):
        """ERNIE-3.0-base shape."""
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=128, type_vocab_size=2,
                   hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  **kw)
        self.use_task_id = cfg.use_task_id
        if cfg.use_task_id:
            self.task_type_embeddings = nn.Embedding(
                cfg.task_type_vocab_size, h, **kw)
        self.layer_norm = LayerNorm(h, cfg.layer_norm_epsilon, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids))
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class ErnieSelfAttention(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        kw = dict(device=device, dtype=dtype)
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.attn_dropout = cfg.attention_dropout_prob
        self.generator = generator

    def forward(self, x, attn_mask=None):
        b, s, e = x.shape
        q, k, v = split_heads(self.qkv(x), self.num_heads)
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout,
            training=self.training, generator=self.generator)
        return self.out(ctx.reshape(b, s, e))


class ErnieLayer(nn.Module):
    """Post-norm encoder block (BERT/ERNIE convention)."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, eps = cfg.hidden_size, cfg.layer_norm_epsilon
        self.attn = ErnieSelfAttention(cfg, device, dtype, generator)
        self.ln1 = LayerNorm(h, eps, **kw)
        self.fc1 = Linear(h, cfg.intermediate_size, **kw)
        self.fc2 = Linear(cfg.intermediate_size, h, **kw)
        self.ln2 = LayerNorm(h, eps, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.dropout(self.attn(x, attn_mask)))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(x + self.dropout(h))


class ErnieModel(nn.Module):
    """The encoder and its pooler. Standing alone it is built as the
    heads are: on ``device`` (``cuda`` unless given; raises with no GPU
    and no device) in ``dtype``, weights from ``seed``, dropout from
    ``dropout_seed``; a head builds it on the meta device and
    materialises it with itself."""

    def __init__(self, config: ErnieConfig, device=None, dtype=torch.float32,
                 seed=0, dropout_seed=0, generator=None):
        super().__init__()
        self.config = config
        standalone = generator is None
        if standalone:
            device = resolve_device(device)
            generator = torch.Generator(device=device).manual_seed(
                int(dropout_seed))
            self.dropout_generator = generator
        meta = "meta"
        self.embeddings = ErnieEmbeddings(config, meta, dtype, generator)
        self.encoder = nn.ModuleList(
            [ErnieLayer(config, meta, dtype, generator)
             for _ in range(config.num_hidden_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             device=meta, dtype=dtype)
        if standalone:
            _materialise(self, device, seed)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        """Returns (sequence_output [B, S, E], pooled_output [B, E]).

        attention_mask: [B, S] with 1 = attend, 0 = padding."""
        mask = None
        if attention_mask is not None:
            # [B, S] -> additive [B, 1, 1, S]
            neg = (1.0 - attention_mask.float()) * -1e30
            mask = neg.reshape(neg.shape[0], 1, 1, neg.shape[1])
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        for layer in self.encoder:
            x = layer(x, mask)
        return x, F.tanh(self.pooler(x[:, 0]))


def _materialise(model, device, seed):
    """Allocate a model built on the meta device and draw its weights as
    the JAX package initialises them (N(0, initializer_range), zero
    biases, unit LayerNorm scales) from a generator seeded by ``seed``."""
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    reset_dense_parameters(model, gen, model.config.initializer_range)


class _ErnieHead(nn.Module):
    """A head over the encoder: built on ``device`` (``cuda`` unless
    given; raises with no GPU and no device) in ``dtype``, weights drawn
    from ``seed`` (``_materialise``), dropout from ``dropout_seed``."""

    def _start(self, config, device, dropout_seed):
        self.config = config
        device = resolve_device(device)
        self.dropout_generator = torch.Generator(device=device).manual_seed(
            int(dropout_seed))
        return device


class ErnieForPretraining(_ErnieHead):
    """Masked-LM (tied decoder) + sentence-order prediction heads."""

    def __init__(self, config: ErnieConfig, device=None, dtype=torch.float32,
                 seed=0, dropout_seed=0):
        super().__init__()
        device = self._start(config, device, dropout_seed)
        cfg, meta = config, "meta"
        # registered first: the JAX package lists it before the layers
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size,
                                                 device=meta, dtype=dtype))
        self.ernie = ErnieModel(cfg, dtype=dtype,
                                generator=self.dropout_generator)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    device=meta, dtype=dtype)
        self.mlm_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                                device=meta, dtype=dtype)
        self.sop_head = Linear(cfg.hidden_size, 2, device=meta, dtype=dtype)
        _materialise(self, device, seed)
        with torch.no_grad():
            self.mlm_bias.zero_()

    def _mlm_logits(self, hidden):
        h = self.mlm_ln(F.gelu(self.mlm_transform(hidden)))
        return F.linear(h, self.ernie.embeddings.word_embeddings.weight) \
            + self.mlm_bias

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_lm_labels=None,
                sop_labels=None):
        """masked_lm_labels: [B, S] with -100 = unmasked (ignored).
        Returns (mlm_logits, sop_logits) or, with labels, the summed loss
        (mean over masked positions + mean sop CE)."""
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        mlm_logits = self._mlm_logits(seq)
        sop_logits = self.sop_head(pooled)
        if masked_lm_labels is None:
            return mlm_logits, sop_logits
        vocab = self.config.vocab_size
        loss = F.cross_entropy(mlm_logits.reshape(-1, vocab),
                               masked_lm_labels.reshape(-1))
        if sop_labels is not None:
            loss = loss + F.cross_entropy(sop_logits, sop_labels.reshape(-1))
        return loss


class ErnieForMaskedLM(nn.Module):
    """The pretraining model's MLM head alone; its weights live under
    ``_pre`` as in the JAX package."""

    def __init__(self, config: ErnieConfig, device=None, dtype=torch.float32,
                 seed=0, dropout_seed=0):
        super().__init__()
        self._pre = ErnieForPretraining(config, device, dtype, seed,
                                        dropout_seed)
        self.config = config

    @property
    def ernie(self):
        return self._pre.ernie

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None, labels=None):
        seq, _ = self.ernie(input_ids, token_type_ids, None, attention_mask)
        logits = self._pre._mlm_logits(seq)
        if labels is None:
            return logits
        return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))


class ErnieForSequenceClassification(_ErnieHead):
    def __init__(self, config: ErnieConfig, num_classes=2, dropout=None,
                 device=None, dtype=torch.float32, seed=0, dropout_seed=0):
        super().__init__()
        device = self._start(config, device, dropout_seed)
        meta = "meta"
        self.ernie = ErnieModel(config, dtype=dtype,
                                generator=self.dropout_generator)
        self.num_classes = num_classes
        p = config.hidden_dropout_prob if dropout is None else dropout
        self.dropout = Dropout(p, self.dropout_generator)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 device=meta, dtype=dtype)
        _materialise(self, device, seed)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids, None,
                               attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels.reshape(-1))
