"""Paddle's SGD and AdamW in plain PyTorch.

Port of ``paddle_tpu/optimizer/optimizer.py``: ``Optimizer.step``,
``clear_grad`` and ``_master``, ``SGD``, ``_AdamBase._adam_update`` and
``AdamW``. These are
Paddle's semantics (``multi_precision=True``), not ``torch.optim``'s:

- every low-precision float parameter keeps an f32 master copy, which
  the update reads and writes, and the parameter receives it rounded to
  its own dtype;
- moments are f32 tensors and the beta powers f32 scalars, per
  parameter (the scalars live on the host, computed in f32 as the JAX
  package computes them, so the update takes them as plain numbers);
- the decoupled decay scales the base first, ``base * (1 - lr*coeff)``,
  then ``base - lr * m_hat / (sqrt(v_hat) + eps)``.

State lives on each parameter's device. The update runs parameter by
parameter, in place, so its temporaries stay the size of one parameter.
Not ported yet: ``Adam`` and the other optimizers, ``multi_precision=
False``, SGD's weight decay, ``apply_decay_param_fun``, ``lr_ratio``,
grad clip, LR schedulers and the state dict.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Optimizer", "SGD", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None):
        if parameters is None:
            raise ValueError("the optimizer needs parameters= (e.g. "
                             "model.parameters())")
        self._parameter_list = list(parameters)
        self._learning_rate = float(learning_rate)
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        self._beta_pows: dict[int, tuple[np.float32, np.float32]] = {}

    def get_lr(self) -> float:
        return self._learning_rate

    def _acc(self, name, p):
        """The f32 accumulator ``name`` of ``p``, zeros at first."""
        store = self._accumulators.setdefault(name, {})
        t = store.get(id(p))
        if t is None:
            t = store[id(p)] = torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
        return t

    def _master(self, p):
        """f32 master weight of a low-precision float parameter."""
        if p.dtype == torch.float32 or not p.is_floating_point():
            return None
        m = self._master_weights.get(id(p))
        if m is None:
            m = self._master_weights[id(p)] = p.detach().float()
        return m

    @torch.no_grad()
    def step(self) -> None:
        lr = self.get_lr()
        for p in self._parameter_list:
            if p.requires_grad and p.grad is not None:
                self._update_param(p, p.grad, lr)

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None


class SGD(Optimizer):
    """``p - lr * g``: Paddle's SGD. A low-precision parameter is updated
    through its f32 master copy and receives it rounded."""

    def _update_param(self, p, g, lr):
        # lr * g in f32 and the subtraction as two roundings, as the JAX
        # package computes them (one fused multiply-add would round once)
        step = g.to(torch.float32, copy=True).mul_(lr)
        master = self._master(p)
        if master is None:
            p.sub_(step.to(p.dtype))
        else:
            master.sub_(step)
            p.copy_(master)


class AdamW(Optimizer):
    """Adam with decoupled weight decay ``weight_decay`` (a float)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01):
        super().__init__(learning_rate, parameters)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._coeff = weight_decay

    def _update_param(self, p, g, lr):
        b1, b2 = self._beta1, self._beta2
        m_t, v_t = self._acc("moment1", p), self._acc("moment2", p)
        one = np.float32(1.0)
        b1p, b2p = self._beta_pows.get(id(p), (one, one))
        b1p, b2p = b1p * np.float32(b1), b2p * np.float32(b2)
        self._beta_pows[id(p)] = (b1p, b2p)
        # the grad is read in its own dtype and promoted to f32 inside
        # each op: no f32 copy of it is made
        m_t.mul_(b1).add_(g, alpha=1 - b1)
        v_t.mul_(b2).addcmul_(g, g, value=1 - b2)
        master = self._master(p)
        base = p.data if master is None else master
        if self._coeff:
            base.mul_(1.0 - lr * self._coeff)
        # lr * m_hat / (sqrt(v_hat) + eps) with the bias corrections
        # moved onto the scalars: lr * c2 / (1 - b1p) * m / (sqrt(v) +
        # eps * c2), c2 = sqrt(1 - b2p); one pass fewer over v
        c2 = math.sqrt(1.0 - float(b2p))
        denom = v_t.sqrt().add_(self._epsilon * c2)
        base.addcdiv_(m_t, denom, value=-lr * c2 / (1.0 - float(b1p)))
        if master is not None:
            p.copy_(master)
