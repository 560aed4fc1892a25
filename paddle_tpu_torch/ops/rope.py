"""Rotary position embedding, neox layout, in plain PyTorch.

Port of ``paddle_tpu/ops/pallas/rope.py``. The JAX package has no kernel
here either: the rotation is elementwise work next to the projections.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_sin_cos", "apply_rope", "rotate"]


def build_sin_cos(seq_len: int, dim: int, base: float = 10000.0,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables [seq_len, dim/2] in f32, computed in f64 on the
    host exactly as the JAX package does."""
    inv = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    return (torch.tensor(np.sin(freqs), dtype=torch.float32, device=device),
            torch.tensor(np.cos(freqs), dtype=torch.float32, device=device))


def rotate(x: torch.Tensor, sin: torch.Tensor,
           cos: torch.Tensor) -> torch.Tensor:
    """Neox rotation of x [B, S, H, D] by per-token angles sin/cos
    [B or 1, S, D/2] (f32); returns x's dtype."""
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               position_ids: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, S, H, D]; sin/cos tables [max_pos, D/2]; position_ids [B, S]
    (None means 0..S-1). Rotates in f32 and returns x's dtype."""
    if position_ids is None:
        return rotate(x, sin[None, :x.shape[1]], cos[None, :x.shape[1]])
    return rotate(x, sin[position_ids], cos[position_ids])
