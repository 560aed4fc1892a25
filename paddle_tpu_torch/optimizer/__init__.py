"""Optimizers of the port (Paddle's semantics, not ``torch.optim``'s)."""

from .optimizer import SGD, AdamW, Optimizer

__all__ = ["SGD", "AdamW", "Optimizer"]
