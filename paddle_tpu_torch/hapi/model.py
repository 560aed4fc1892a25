"""The high-level ``Model``: ``prepare`` and ``fit``.

Port of ``paddle_tpu/hapi/model.py``: ``Model(network)``,
``prepare(optimizer, loss)``, ``train_batch``, ``_compute_loss``,
``_fused_network_loss`` and ``fit`` with its per-epoch summary
``_last_epoch_summary`` (``epoch``, ``steps``, ``seconds``,
``avg_step_ms``, ``mean_loss``); ``_epoch_summaries`` keeps every epoch's
of the last ``fit``.

``fit(compiled=True)`` keeps the JAX meaning of the step: under
``flags.scoped_default("FLAGS_fused_linear_cross_entropy", True)`` the
labels go into the network when the criterion certifies that the
network's labelled loss equals its own (``fuses_with_network_loss``),
so the loss comes from the fused linear+CE and the [N, V] logits are
never made. Each step's loss stays on the device; the losses are read
at ``log_freq`` and at the end of the epoch. PyTorch has no
``to_static``, so the step runs eagerly. ``fit(compiled=False)`` is the
eager, unfused ``train_batch`` loop (one host read a step), the oracle.

Not ported yet: eval and predict, save and load, checkpoints and
resume, preemption, the device prefetcher and steps in flight, goodput,
AMP and the scaler, metrics and callbacks.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..framework import flags
from ..io import DataLoader

__all__ = ["Model"]


class Model:
    def __init__(self, network):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._last_epoch_summary = None
        self._epoch_summaries = []

    def prepare(self, optimizer=None, loss=None):
        self._optimizer = optimizer
        self._loss = loss

    def _compute_loss(self, outputs, labels):
        if callable(self._loss):
            return self._loss(outputs, labels)
        raise RuntimeError("prepare(loss=...) first")

    def _fused_network_loss(self):
        """True when the step should pass the labels into the network and
        take its fused linear+CE loss: the flag is on (fit's compiled path
        turns it on by default) and the criterion certifies the network's
        labelled loss (``fuses_with_network_loss``)."""
        return (flags.flag("FLAGS_fused_linear_cross_entropy")
                and getattr(self._loss, "fuses_with_network_loss", False))

    def _backward_and_step(self, loss):
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()

    def train_batch(self, inputs, labels=None):
        """One eager step on the materialised outputs; returns
        ``[loss]`` as a Python float (a host read a step)."""
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        loss = self._compute_loss(self.network(*inputs), labels)
        self._backward_and_step(loss)
        return [float(loss.item())]

    def _train_step(self, *batch):
        """fit's compiled step, run eagerly: forward (through the fused
        loss when :meth:`_fused_network_loss`), backward and update. The
        loss is returned on the device."""
        *xs, y = batch
        self.network.train()
        if self._fused_network_loss():
            loss = self.network(*xs, labels=y)[1]
        else:
            loss = self._compute_loss(self.network(*xs), y)
        self._backward_and_step(loss)
        return loss.detach()

    def _fit_epoch_compiled(self, loader, epoch, log_freq, verbose, device):
        losses, pending = [], []

        def resolve():
            # the epoch's only host reads of the device
            if pending:
                losses.extend(torch.stack(pending).tolist())
                pending.clear()

        for step, batch in enumerate(loader):
            pending.append(self._train_step(*_to(batch, device)))
            if step % log_freq == 0:
                resolve()
                if verbose:
                    print(f"epoch {epoch} step {step}: loss "
                          f"{losses[-1]:.5f}")
        resolve()
        return losses

    def _fit_epoch_eager(self, loader, epoch, log_freq, verbose, device):
        losses = []
        for step, batch in enumerate(loader):
            *xs, y = _to(batch, device)
            losses.append(self.train_batch(xs, y)[0])
            if verbose and step % log_freq == 0:
                print(f"epoch {epoch} step {step}: loss {losses[-1]:.5f}")
        return losses

    def fit(self, train_data=None, batch_size=1, epochs=1, shuffle=True,
            drop_last=False, verbose=2, log_freq=10, compiled=True):
        """Train for ``epochs`` over ``train_data`` (a ``TensorDataset``,
        batched here, or a ``DataLoader``). Batches move to the device of
        the network's parameters. After each epoch
        ``_last_epoch_summary`` holds its ``steps``, ``seconds`` (host
        clock, up to the last loss read), ``avg_step_ms`` and
        ``mean_loss``."""
        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last)
        device = next(self.network.parameters()).device
        run_epoch = self._fit_epoch_compiled if compiled \
            else self._fit_epoch_eager
        self._epoch_summaries = []
        with contextlib.ExitStack() as scope:
            if compiled:
                # restored on exit, so eager code outside fit stays the
                # unfused oracle; an explicit env/set_flags value wins
                scope.enter_context(flags.scoped_default(
                    "FLAGS_fused_linear_cross_entropy", True))
            for epoch in range(epochs):
                t0 = time.perf_counter()
                losses = run_epoch(loader, epoch, log_freq, verbose, device)
                seconds = time.perf_counter() - t0
                summary = {
                    "epoch": epoch, "steps": len(losses), "seconds": seconds,
                    "avg_step_ms": seconds / max(len(losses), 1) * 1e3,
                    "mean_loss": float(np.mean(losses)) if losses else None}
                self._last_epoch_summary = summary
                self._epoch_summaries.append(summary)
                if verbose:
                    print(f"epoch {epoch} done: {summary['steps']} steps in "
                          f"{seconds:.2f}s (avg {summary['avg_step_ms']:.1f} "
                          f"ms/step)")


def _to(batch, device):
    return [t.to(device, non_blocking=True) for t in batch]
