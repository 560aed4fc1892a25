"""The weight bridge from the JAX package's state dict.

``from_numpy_state_dict(model, arrays)`` loads a ``paddle_tpu`` model's
``state_dict()``, given as numpy arrays under the same keys, into the
port's model. Paddle's Linear holds its weight as [in, out] and
``torch.nn.Linear`` as [out, in], so every Linear weight (``lm_head``
included) is transposed; embeddings ([V, H]) and norm weights are taken
as they are. A missing or unexpected key raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["from_numpy_state_dict"]


@torch.no_grad()
def from_numpy_state_dict(model: nn.Module,
                          arrays: dict[str, np.ndarray]) -> nn.Module:
    target = model.state_dict()
    missing = sorted(set(target) - set(arrays))
    unexpected = sorted(set(arrays) - set(target))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    linear = {f"{name}.weight" for name, mod in model.named_modules()
              if isinstance(mod, nn.Linear)}
    for key, dst in target.items():
        src = np.asarray(arrays[key])
        if src.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy
            src = src.astype(np.float32)
        if key in linear:
            src = src.T
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} does not "
                             f"fit {tuple(dst.shape)}")
        dst.copy_(torch.tensor(src))
    return model
