"""Dynamic loss scaling: a port of ``paddle_tpu/amp/grad_scaler.py``.

The same algorithm: the loss is multiplied by the scale before the
backward; ``unscale_`` divides the grads by it and looks for an inf or a
NaN; ``step`` skips the optimizer's step when one was found; ``update``
halves the scale (``decr_ratio``) after ``decr_every_n_nan_or_inf`` bad
steps in a row (never below 1) and doubles it (``incr_ratio``) after
``incr_every_n_steps`` good ones, the factors applied in f32.

The JAX package keeps the scale and the two counters as device scalars
and decides the skip on the device, for its compiled step. The port's
step is eager: the scale and the counters are host numbers, and
``unscale_`` reads one device bool a step (whether any grad is not
finite), its only host synchronisation.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # guards the unscale_-then-step pattern against double unscaling
        self._unscaled_since_step = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v) -> None:
        self._scale = float(v)

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        """``var`` times the scale, in ``var``'s dtype."""
        if not self._enable:
            return var
        # the scale rounded to var's dtype first, as the JAX package casts it
        return var * torch.tensor(self._scale).to(var.dtype).item()

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        if not self._enable:
            return
        if self._unscaled_since_step:
            raise RuntimeError(
                "GradScaler.unscale_() already called since the last "
                "step()/update(); calling it twice would double-unscale "
                "the gradients")
        self._unscaled_since_step = True
        inv = float(np.float32(1.0) / np.float32(self._scale))
        bad = None
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            # in the grad's own dtype, as the JAX package unscales
            g = p.grad.mul_(inv)
            nonfinite = ~torch.isfinite(g).all()
            bad = nonfinite if bad is None else bad | nonfinite
        self._found_inf = bool(bad.item()) if bad is not None else False

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled_since_step:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss) -> None:
        self.step(optimizer)

    def update(self) -> None:
        """The reference algorithm (module docstring), as the JAX
        package's traced update computes it."""
        self._unscaled_since_step = False
        if not (self._enable and self._dynamic):
            return
        found = self._found_inf
        bad_next = self._bad_steps + 1 if found else 0
        good_next = 0 if found else self._good_steps + 1
        shrink = bad_next >= self._decr_every_n
        grow = good_next >= self._incr_every_n_steps
        f32 = np.float32
        if shrink:
            self._scale = float(max(f32(self._scale) * f32(self._decr_ratio),
                                    f32(1.0)))
        elif grow:
            self._scale = float(f32(self._scale) * f32(self._incr_ratio))
        self._bad_steps = 0 if shrink else bad_next
        self._good_steps = 0 if grow else good_next
        self._found_inf = False

    def state_dict(self) -> dict:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state: dict) -> None:
        self._scale = float(state.get("scale", self._scale))
        self._good_steps = int(state.get("incr_count", 0))
        self._bad_steps = int(state.get("decr_count", 0))


AmpScaler = GradScaler
