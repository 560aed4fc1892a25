"""Optimizers of the port (Paddle's semantics, not ``torch.optim``'s)."""

from .optimizer import AdamW, Optimizer

__all__ = ["AdamW", "Optimizer"]
