"""Optimizers of the port (Paddle's semantics, not ``torch.optim``'s),
their LR schedulers (``lr``) and the gradient clips."""

from . import lr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, Lamb, Momentum, NAdam, Optimizer, RAdam,
                        RMSProp, Rprop, param_name)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LBFGS", "Rprop",
           "ASGD", "NAdam", "RAdam", "lr",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "param_name"]
