"""Paddle's optimizers in plain PyTorch.

Port of ``paddle_tpu/optimizer/optimizer.py``: the ``Optimizer`` base
(learning rate as a float or an ``LRScheduler``, ``weight_decay`` as a
float or a regularizer, a parameter's own ``regularizer`` first,
``grad_clip`` before the updates, parameter groups, the step count and
the state dict), ``SGD``, ``Momentum``, ``Adam``, ``AdamW``
(``apply_decay_param_fun``, ``lr_ratio``), ``Adamax``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``Lamb``, ``LBFGS``, ``Rprop``, ``ASGD``,
``NAdam`` and ``RAdam``. These are Paddle's semantics, not
``torch.optim``'s:

- with ``multi_precision=True`` (the default) a low-precision float
  parameter keeps an f32 master copy, which the update reads and writes,
  and the parameter receives it rounded to its own dtype; without it the
  update runs in f32 on a copy and is rounded once into the parameter;
- slots are f32 tensors on each parameter's device, made at the first
  step; the beta powers of the Adam family are f32 scalars on the host,
  computed in f32 as the JAX package computes them, so the update takes
  them as plain numbers;
- the decoupled decay scales the base first, ``base * (1 - lr*coeff)``,
  then ``base - lr * m_hat / (sqrt(v_hat) + eps)``.

The update runs parameter by parameter, in place, under ``no_grad``, so
its temporaries stay the size of one parameter.

State-dict keys are the JAX package's: ``<key>_<slot>`` (``moment1``,
``moment2``, ``beta1_pow``, ``velocity``, ...), ``<key>_master``,
``LR_Scheduler`` and ``@step``, where ``<key>`` is the parameter's
name when one was set, else ``param_<i>`` by its position (a JAX
``Parameter`` built without ``ParamAttr`` has the name ``""``, so both
packages key by position). torch's ``Tensor.name`` is read-only, so a
port parameter's name is its ``param_name`` attribute (:func:`
param_name`). ``set_state_dict`` before the first step
stashes what it cannot place yet and applies it as the slots are made.
Values may be tensors or numpy arrays; Linear slots in the JAX
package's [in, out] layout go through ``convert.from_numpy_optimizer_
state`` first. A slot or master weight of a parameter that holds a
rank's part of a tensor (tensor-parallel, ZeRO stage 3) takes the
parameter's layout in ``state_dict()`` (``distributed.checkpoint.
metadata``), and ``set_state_dict`` cuts this rank's part from a full
tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..distributed.checkpoint.metadata import layout_of, local_part, \
    with_layout
from ..regularizer import WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LBFGS", "Rprop",
           "ASGD", "NAdam", "RAdam", "param_name"]

_ONE = np.float32(1.0)


def param_name(p) -> str:
    """A parameter's name: its ``param_name`` attribute, ``""`` when none
    was set (what the JAX package's unnamed parameters give)."""
    return getattr(p, "param_name", "")


def _tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def _local(src, p, shape):
    """A stored slot (or master weight) of ``p`` as a tensor of
    ``shape``: this rank's part when ``src`` is the full tensor."""
    src = _tensor(src)
    if src.numel() != math.prod(shape):
        src = local_part(src, layout_of(p))
    return src.reshape(shape)


def _scalar(v):
    """A beta power from a state dict (0-d tensor, array or number)."""
    return np.float32(float(v.item() if hasattr(v, "item") else v))


class Optimizer:
    _has_beta2_pow = True       # Adamax keeps beta1's power only

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if parameters is None:
            raise ValueError("the optimizer needs parameters= (e.g. "
                             "model.parameters())")
        self._parameter_list = list(parameters)
        self._param_groups = None
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            # the groups' own settings are not read, as in the JAX package
            self._param_groups = self._parameter_list
            self._parameter_list = [p for g in self._param_groups
                                    for p in g["params"]]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        # Adam family: (beta1^t, beta2^t) per parameter, f32 on the host
        self._beta_pows: dict[int, tuple[np.float32, np.float32]] = {}
        self._step_count = 0
        self._pending_state: dict | None = None
        self._keys = {id(p): (param_name(p) or f"param_{i}")
                      for i, p in enumerate(self._parameter_list)}

    # -- lr ---------------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when a LRScheduler is in use")
        self._learning_rate = value

    # -- slots --------------------------------------------------------------

    def _param_key(self, p) -> str:
        return self._keys.get(id(p), str(id(p)))

    def _param_of(self, key):
        """The parameter whose state ``key`` (``<param key>_<slot>``)
        holds, or None (``@step``, ``LR_Scheduler``)."""
        best, width = None, -1
        for p in self._parameter_list:
            pk = self._param_key(p)
            if key.startswith(pk + "_") and len(pk) > width:
                best, width = p, len(pk)
        return best

    def _pending(self, key):
        """Stashed state for ``key``, handed over once (the stash holds
        host copies of the slots until they are made)."""
        return (self._pending_state or {}).pop(key, None)

    def _acc(self, name, p, fill=0.0, shape=None):
        """The f32 slot ``name`` of ``p`` (``fill`` at first, or what a
        stashed state dict holds for it)."""
        store = self._accumulators.setdefault(name, {})
        t = store.get(id(p))
        if t is None:
            src = self._pending(f"{self._param_key(p)}_{name}")
            shape = p.shape if shape is None else shape
            if src is None:
                t = torch.full(shape, fill, dtype=torch.float32,
                               device=p.device)
            else:
                t = _local(src, p, shape).to(
                    device=p.device, dtype=torch.float32, copy=True)
            store[id(p)] = t
        return t

    def _master(self, p):
        """f32 master weight of a low-precision float parameter."""
        if not self._multi_precision or p.dtype == torch.float32 \
                or not p.is_floating_point():
            return None
        m = self._master_weights.get(id(p))
        if m is None:
            src = self._pending(f"{self._param_key(p)}_master")
            m = p.detach().float() if src is None else _local(
                src, p, p.shape).to(device=p.device, dtype=torch.float32,
                                    copy=True)
            self._master_weights[id(p)] = m
        return m

    def _base(self, p):
        """What the update writes in f32: the master copy, the parameter
        itself when it is f32, else an f32 copy (:meth:`_write` rounds it
        into the parameter)."""
        master = self._master(p)
        if master is not None:
            return master
        return p.data if p.dtype == torch.float32 else p.detach().float()

    @staticmethod
    def _write(p, base):
        if base.data_ptr() != p.data_ptr():
            p.copy_(base)

    def _next_pows(self, p, b1, b2):
        """(beta1^t, beta2^t) after this step, in f32."""
        key = self._param_key(p)
        pows = self._beta_pows.get(id(p))
        if pows is None:
            stashed = (self._pending(f"{key}_{n}")
                       for n in ("beta1_pow", "beta2_pow"))
            pows = tuple(_ONE if v is None else _scalar(v) for v in stashed)
        pows = (pows[0] * np.float32(b1), pows[1] * np.float32(b2))
        self._beta_pows[id(p)] = pows
        return pows

    # -- step --------------------------------------------------------------

    def _decay_grad(self, p, g):
        """Coupled weight decay folded into a grad: a parameter's own
        ``regularizer`` first, else ``weight_decay`` (a float or a
        regularizer)."""
        wd = getattr(p, "regularizer", None)
        if wd is None:
            wd = self._weight_decay
        if wd is None or wd == 0.0:
            return g
        pd = p.detach().to(g.dtype)
        if isinstance(wd, WeightDecayRegularizer):
            return wd(pd, g)
        coeff = float(wd[0] if isinstance(wd, (list, tuple)) else wd)
        return g + coeff * pd

    def _clipped(self):
        """``[(param, grad)]`` of the parameters that have a grad, after
        ``grad_clip``: the first half of :meth:`step`."""
        pgs = [(p, p.grad) for p in self._parameter_list
               if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        return pgs

    @torch.no_grad()
    def _apply(self, pgs) -> None:
        """The updates of :meth:`step` over ``pgs``, and the count."""
        lr = self.get_lr()
        for p, g in pgs:
            self._update_param(p, g, lr)
        self._step_count += 1

    @torch.no_grad()
    def step(self) -> None:
        self._apply(self._clipped())

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict --------------------------------------------------------

    def _by_id(self):
        return {id(p): p for p in self._parameter_list}

    def state_dict(self) -> dict:
        """Live slot tensors, the beta powers as 0-d f32 tensors on the
        parameter's device, the master weights, ``LR_Scheduler`` (a
        scheduler's state) and ``@step``."""
        params = self._by_id()
        sd = {}

        def placed(t, p):
            # a slot of the parameter's shape takes its layout
            return with_layout(t, layout_of(p)) if t.shape == p.shape \
                else t
        for name, store in self._accumulators.items():
            for pid, t in store.items():
                p = params[pid]
                sd[f"{self._param_key(p)}_{name}"] = placed(t, p)
        for pid, (b1p, b2p) in self._beta_pows.items():
            p = params[pid]
            key = self._param_key(p)
            sd[f"{key}_beta1_pow"] = torch.tensor(b1p, device=p.device)
            if self._has_beta2_pow:
                sd[f"{key}_beta2_pow"] = torch.tensor(b2p, device=p.device)
        for pid, t in self._master_weights.items():
            p = params[pid]
            sd[f"{self._param_key(p)}_master"] = placed(t, p)
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["@step"] = self._step_count
        return sd

    @torch.no_grad()
    def set_state_dict(self, state: dict) -> None:
        """Restore optimizer state. Slots are made at the first step, so
        state for slots that do not exist yet is stashed and applied as
        they are made. Values are copied now: ``state_dict()`` hands out
        live tensors, and their owner may keep stepping."""
        self._pending_state = {
            k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}
        params = self._by_id()
        for name, store in self._accumulators.items():
            for pid, t in store.items():
                src = state.get(f"{self._param_key(params[pid])}_{name}")
                if src is not None:
                    t.copy_(_local(src, params[pid], t.shape))
        for pid, t in self._master_weights.items():
            src = state.get(f"{self._param_key(params[pid])}_master")
            if src is not None:
                t.copy_(_local(src, params[pid], t.shape))
        for pid, (b1p, b2p) in list(self._beta_pows.items()):
            key = self._param_key(params[pid])
            s1, s2 = (state.get(f"{key}_beta{i}_pow") for i in (1, 2))
            self._beta_pows[pid] = (b1p if s1 is None else _scalar(s1),
                                    b2p if s2 is None else _scalar(s2))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        self._step_count = int(state.get("@step", self._step_count))


class SGD(Optimizer):
    """``p - lr * g`` (the grad with its coupled decay). A low-precision
    parameter is updated through its f32 master copy and receives it
    rounded."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update_param(self, p, g, lr):
        g = self._decay_grad(p, g)
        # lr * g in f32 and the subtraction as two roundings, as the JAX
        # package computes them (one fused multiply-add would round once)
        step = g.to(torch.float32, copy=True).mul_(lr)
        master = self._master(p)
        if master is None:
            p.sub_(step.to(p.dtype))
        else:
            master.sub_(step)
            p.copy_(master)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_param(self, p, g, lr):
        g = self._decay_grad(p, g.float())
        vel = self._acc("velocity", p)
        vel.mul_(self._momentum).add_(g)
        upd = g + self._momentum * vel if self._nesterov else vel
        base = self._base(p)
        base.sub_(lr * upd)
        self._write(p, base)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _betas(self):
        return tuple(float(b() if callable(b) else b)
                     for b in (self._beta1, self._beta2))

    def _moments(self, p, g):
        """m, v updated in place with ``g`` (any float dtype; promoted to
        f32 inside each op, no f32 copy of it is made) and the beta
        powers after this step."""
        b1, b2 = self._betas()
        m_t, v_t = self._acc("moment1", p), self._acc("moment2", p)
        b1p, b2p = self._next_pows(p, b1, b2)
        m_t.mul_(b1).add_(g, alpha=1 - b1)
        v_t.mul_(b2).addcmul_(g, g, value=1 - b2)
        return m_t, v_t, b1p, b2p

    def _adam_update(self, p, g, lr, decoupled_wd=0.0, apply_l2=True):
        if apply_l2 and not decoupled_wd:
            g = self._decay_grad(p, g)
        m_t, v_t, b1p, b2p = self._moments(p, g)
        base = self._base(p)
        if decoupled_wd:
            base.mul_(1.0 - lr * decoupled_wd)
        # lr * m_hat / (sqrt(v_hat) + eps) with the bias corrections
        # moved onto the scalars: lr * c2 / (1 - b1p) * m / (sqrt(v) +
        # eps * c2), c2 = sqrt(1 - b2p); one pass fewer over v
        c2 = math.sqrt(1.0 - float(b2p))
        denom = v_t.sqrt().add_(self._epsilon * c2)
        base.addcdiv_(m_t, denom, value=-lr * c2 / (1.0 - float(b1p)))
        self._write(p, base)


class Adam(_AdamBase):
    def _update_param(self, p, g, lr):
        self._adam_update(p, g, lr)


class AdamW(_AdamBase):
    """Adam with decoupled weight decay ``weight_decay`` (a float);
    ``apply_decay_param_fun(name)`` false leaves a parameter undecayed
    (``name`` is :func:`param_name`, ``""`` when none was set, as a JAX
    parameter built without ``ParamAttr`` has), and ``lr_ratio(p)``
    scales its learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update_param(self, p, g, lr):
        decay = self._coeff
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(param_name(p)):
            decay = 0.0
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        self._adam_update(p, g, lr, decoupled_wd=decay, apply_l2=False)


class Adamax(_AdamBase):
    _has_beta2_pow = False

    def _update_param(self, p, g, lr):
        b1, b2 = self._betas()
        g = self._decay_grad(p, g.float())
        m_t, u_t = self._acc("moment", p), self._acc("inf_norm", p)
        b1p, _ = self._next_pows(p, b1, 1.0)
        m_t.mul_(b1).add_(g, alpha=1 - b1)
        u_t.copy_(torch.maximum(u_t * b2, g.abs()))
        base = self._base(p)
        base.sub_(lr / (1 - b1p) * m_t / (u_t + self._epsilon))
        self._write(p, base)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr):
        g = self._decay_grad(p, g.float())
        acc = self._acc("moment", p, fill=self._init_acc)
        acc.addcmul_(g, g)
        p.copy_(p.float() - lr * g / (acc.sqrt() + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _update_param(self, p, g, lr):
        g = self._decay_grad(p, g.float())
        rho, eps = self._rho, self._epsilon
        avg_sq = self._acc("avg_squared_grad", p)
        avg_up = self._acc("avg_squared_update", p)
        avg_sq.mul_(rho).addcmul_(g, g, value=1 - rho)
        upd = (avg_up + eps).sqrt() / (avg_sq + eps).sqrt() * g
        avg_up.mul_(rho).addcmul_(upd, upd, value=1 - rho)
        p.copy_(p.float() - lr * upd)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_param(self, p, g, lr):
        g = self._decay_grad(p, g.float())
        rho = self._rho
        ms = self._acc("mean_square", p)
        mom = self._acc("momentum", p)
        ms.mul_(rho).addcmul_(g, g, value=1 - rho)
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg.mul_(rho).add_(g, alpha=1 - rho)
            denom = (ms - mg * mg + self._epsilon).sqrt()
        else:
            denom = (ms + self._epsilon).sqrt()
        mom.mul_(self._momentum).add_(lr * g / denom)
        p.copy_(p.float() - mom)


class Lamb(_AdamBase):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, name=name)
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr):
        m_t, v_t, b1p, b2p = self._moments(p, g.float())
        m_hat = m_t / (1 - b1p)
        v_hat = v_t / (1 - b2p)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        pf = p.float()
        r = m_hat / (v_hat.sqrt() + self._epsilon) + wd * pf
        w_norm, r_norm = torch.linalg.vector_norm(pf), \
            torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.copy_(pf - lr * trust * r)


class LBFGS(Optimizer):
    """As in the JAX package: ``step(closure)`` calls the closure and
    takes a plain gradient step, no line search (full L-BFGS is not in
    the reference either); no clip, no decay, no step count."""

    def __init__(self, learning_rate=1.0, max_iter=20, parameters=None,
                 **kw):
        super().__init__(learning_rate, parameters)

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        with torch.no_grad():
            lr = self.get_lr()
            for p in self._parameter_list:
                if p.requires_grad and p.grad is not None:
                    p.sub_(lr * p.grad)
        return loss


class Rprop(Optimizer):
    """Resilient backpropagation: per-element step sizes grown or shrunk
    by the sign agreement of successive gradients (iRprop-: a flipped
    sign zeroes the stored grad)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = (float(learning_rate_range[0]),
                                      float(learning_rate_range[1]))
        self._eta_minus, self._eta_plus = float(etas[0]), float(etas[1])

    def _update_param(self, p, g, lr):
        g = g.float()
        prev = self._acc("prev_grad", p)
        step = self._acc("step_size", p, fill=float(lr))
        sign = torch.sign(g) * torch.sign(prev)
        factor = torch.where(sign > 0, self._eta_plus,
                             torch.where(sign < 0, self._eta_minus, 1.0))
        step.mul_(factor).clamp_(self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g)
        prev.copy_(g_eff)
        p.copy_(p.float() - torch.sign(g_eff) * step)


class ASGD(Optimizer):
    """Averaged SGD: SGD steps along the running mean of the last
    ``batch_num`` grads (a streaming mean, as the JAX package keeps)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = max(int(batch_num), 1)

    def _update_param(self, p, g, lr):
        g = self._decay_grad(p, g.float())
        buf = self._acc("grad_mean", p)
        n_t = self._acc("n_seen", p, shape=())
        n_t.add_(1.0).clamp_(max=float(self._batch_num))
        buf.add_((g - buf) / n_t)
        p.copy_(p.float() - lr * buf)


class NAdam(_AdamBase):
    """Nesterov-momentum Adam."""

    def _update_param(self, p, g, lr):
        b1, _ = self._betas()
        g = self._decay_grad(p, g.float())
        m, v, b1p, b2p = self._moments(p, g)
        m_hat = b1 * m / (1 - b1p * np.float32(b1)) + (1 - b1) * g / (1 - b1p)
        v_hat = v / (1 - b2p)
        base = self._base(p)
        base.sub_(lr * m_hat / (v_hat.sqrt() + self._epsilon))
        self._write(p, base)


class RAdam(_AdamBase):
    """Rectified Adam: the variance rectification of each step, momentum
    SGD while the variance estimate is not trusted (rho_t <= 5). The
    step's t comes from beta2^t, in f32 as the JAX package computes it."""

    def _update_param(self, p, g, lr):
        _, beta2 = self._betas()
        g = self._decay_grad(p, g.float())
        m, v, b1p, b2p = self._moments(p, g)
        f = np.float32
        rho_inf = f(2.0 / (1 - beta2) - 1.0)
        t = np.log(b2p) / np.log(f(beta2))
        rho_t = rho_inf - f(2.0) * t * b2p / (_ONE - b2p)
        m_hat = m / (1 - b1p)
        base = self._base(p)
        if rho_t > 5.0:
            r_num = (rho_t - f(4)) * (rho_t - f(2)) * rho_inf
            r_den = (rho_inf - f(4)) * (rho_inf - f(2)) * rho_t
            rect = np.sqrt(max(r_num / max(r_den, f(1e-30)), f(0)))
            v_hat = (v / (1 - b2p)).sqrt()
            base.sub_(lr * (float(rect) * m_hat / (v_hat + self._epsilon)))
        else:
            base.sub_(lr * m_hat)
        self._write(p, base)
