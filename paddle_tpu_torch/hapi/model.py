"""The high-level ``Model``: a port of ``paddle_tpu/hapi/model.py``.

``Model(network)``, ``prepare(optimizer, loss, metrics, amp_configs,
scaler)``, ``train_batch``/``eval_batch``/``predict_batch``, ``fit``,
``evaluate``, ``predict``, ``save``/``load`` (the ``.pdparams``/``.pdopt``
pickle of ``framework.io``), ``save_checkpoint``/``load_checkpoint``
(the committed checkpoint directories of ``distributed.checkpoint``),
``parameters`` and ``summary``.

``fit(compiled=True)`` keeps the JAX meaning of the step: under
``flags.scoped_default("FLAGS_fused_linear_cross_entropy", True)`` the
labels go into the network when the criterion certifies that the
network's labelled loss equals its own (``fuses_with_network_loss``),
so the loss comes from the fused linear+CE and the [N, V] logits are
never made. Each step's loss stays on the device; the losses are read
at ``log_freq`` and at the end of the epoch, and each loss read is one
``utils.monitor.emit_step_metrics(epoch=, loss=)`` record. PyTorch has
no ``to_static``, so the step runs eagerly. ``fit(compiled=False)`` is
the eager, unfused ``train_batch`` loop (one host read a step), the
oracle. After each epoch ``_last_epoch_summary`` holds its ``epoch``,
``steps``, ``seconds``, ``avg_step_ms`` and ``mean_loss``;
``_epoch_summaries`` keeps every epoch's of the last ``fit``.

AMP: ``amp_configs`` ``"O1"`` runs the forward and the loss under
``amp.auto_cast``; ``"O2"`` also casts the parameters with
``amp.decorate``. A ``GradScaler`` given to ``prepare`` scales the loss
and unscales, skips and updates around the optimizer's step.

Not ported yet: preemption and the emergency checkpoint, the goodput
ledger, the device prefetcher and steps in flight (the JAX package's
compiled step dispatches ahead; the port's eager step runs in order),
and workers for the loader (``num_workers`` is accepted and not used).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..amp import auto_cast, decorate
from ..distributed import checkpoint as dckpt
from ..framework import flags
from ..framework.io import load as load_obj
from ..framework.io import save as save_obj
from ..io import DataLoader
from ..utils import monitor

__all__ = ["Model"]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._scaler = None
        self._metrics = []
        self._amp_level = None
        self._resume_mid_step = None
        self._last_epoch_summary = None
        self._epoch_summaries = []

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, scaler=None):
        """``amp_configs``: ``"O0"``/``"O1"``/``"O2"`` or a dict with
        ``"level"``; O2 casts the network's parameters in place
        (``amp.decorate``), the optimizer keeping its ``Parameter``
        objects. ``scaler``: a ``GradScaler`` the train steps go
        through."""
        self._optimizer = optimizer
        self._loss = loss
        self._scaler = scaler
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        self._amp_level = None
        if amp_configs is not None:
            if isinstance(amp_configs, str):
                level = amp_configs.upper()
            else:
                level = str(amp_configs.get("level", "O1")).upper()
            if level not in ("O0", "O1", "O2"):
                raise ValueError(f"amp_configs level must be O0/O1/O2, got "
                                 f"{level}")
            if level != "O0":
                self._amp_level = level
            if level == "O2":
                out = decorate(models=self.network,
                               optimizers=self._optimizer, level="O2")
                self.network = out[0] if isinstance(out, (list, tuple)) \
                    else out

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

    def _amp(self):
        if self._amp_level:
            return auto_cast(enable=True, level=self._amp_level)
        return contextlib.nullcontext()

    def _forward_loss(self, xs, y, fused):
        with self._amp():
            if fused:
                return self.network(*xs, labels=y)[1]
            return self._compute_loss(self.network(*xs), y)

    def _backward_and_step(self, loss):
        """Backward and the optimizer's update, through the GradScaler
        when one was prepared (scale, backward, unscale/step/update)."""
        scaler = self._scaler
        if scaler is not None and scaler.is_enable():
            scaler.scale(loss).backward()
            scaler.step(self._optimizer)
        else:
            loss.backward()
            self._optimizer.step()
        self._optimizer.clear_grad()

    def _device(self):
        return next(self.network.parameters()).device

    def train_batch(self, inputs, labels=None, update=True):
        """One eager step on the materialised outputs; returns ``[loss]``
        as a Python float (a host read a step). ``update=False`` leaves
        the grads in place."""
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        loss = self._forward_loss(inputs, labels, False)
        if update:
            self._backward_and_step(loss)
        else:
            loss.backward()
        return [float(loss.item())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        with torch.no_grad():
            loss = self._compute_loss(self.network(*inputs), labels)
        return [float(loss.item())]

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        with torch.no_grad():
            return self.network(*inputs)

    def _train_step(self, *batch):
        """fit's compiled step, run eagerly: forward (through the fused
        loss when :meth:`_fused_network_loss`), backward and update. The
        loss is returned on the device."""
        *xs, y = batch
        self.network.train()
        loss = self._forward_loss(xs, y, self._fused_network_loss())
        self._backward_and_step(loss)
        return loss.detach()

    def _eval_step(self, *batch):
        *xs, y = batch
        self.network.eval()
        with torch.no_grad():
            if self._fused_network_loss():
                return self.network(*xs, labels=y)[1]
            return self._compute_loss(self.network(*xs), y)

    def _fit_epoch_compiled(self, loader, epoch, log_freq, verbose, device,
                            skip_to=0):
        losses, pending = [], []

        def resolve():
            # the epoch's only host reads of the device
            if pending:
                for v in torch.stack(pending).tolist():
                    losses.append(v)
                    monitor.emit_step_metrics(epoch=epoch, loss=v)
                pending.clear()

        for step, batch in enumerate(loader):
            if step < skip_to:
                continue
            pending.append(self._train_step(*_to(batch, device)))
            if step % log_freq == 0:
                resolve()
                if verbose:
                    print(f"epoch {epoch} step {step}: loss "
                          f"{losses[-1]:.5f}")
        resolve()
        return losses

    def _fit_epoch_eager(self, loader, epoch, log_freq, verbose, device,
                         skip_to=0):
        losses = []
        for step, batch in enumerate(loader):
            if step < skip_to:
                continue
            *xs, y = _to(batch, device)
            losses.append(self.train_batch(xs, y)[0])
            monitor.emit_step_metrics(epoch=epoch, loss=losses[-1])
            if verbose and step % log_freq == 0:
                print(f"epoch {epoch} step {step}: loss {losses[-1]:.5f}")
        return losses

    def _resume_point(self, resume, save_dir, verbose):
        """(first epoch, steps of it already done) after loading the
        checkpoint ``resume`` names: a path; ``True`` takes
        ``PADDLE_RESUME_CHECKPOINT``, else the newest valid ``step_N``
        under ``save_dir``. (0, 0) when there is none."""
        path = resume if isinstance(resume, (str, os.PathLike)) else None
        if path is None:
            path = os.environ.get("PADDLE_RESUME_CHECKPOINT")
        if path is None and save_dir is not None:
            path = dckpt.latest_valid_checkpoint(save_dir)
        if not path:
            return 0, 0
        epoch_done = self.load_checkpoint(path)
        mid = self._resume_mid_step
        # a checkpoint taken inside an epoch redoes that epoch from the
        # step after the last one it holds
        start, skip = (epoch_done + 1, 0) if mid is None \
            else (epoch_done, int(mid) + 1)
        if verbose:
            print(f"resuming from {path} (epoch {start}"
                  f"{f' step {skip}' if skip else ''})")
        return start, skip

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, resume=None, keep_last_n=None,
            legacy_save=True, compiled=True):
        """Train for ``epochs`` over ``train_data`` (a ``TensorDataset``,
        batched here, or a ``DataLoader``); batches move to the device of
        the network's parameters.

        ``save_dir``: after every ``save_freq``-th epoch a committed
        ``step_<epoch>`` checkpoint (``keep_last_n`` bounds how many
        stay) and, unless ``legacy_save=False``, ``epoch_<epoch>.pdparams``
        / ``.pdopt``. ``eval_data``: ``evaluate`` after every
        ``eval_freq``-th epoch. ``resume=True`` restarts from the newest
        committed checkpoint (``PADDLE_RESUME_CHECKPOINT``, else the
        newest valid ``step_N`` under ``save_dir``), ``resume=<path>``
        from that one; the epochs it holds are skipped. A loader fit
        builds seeds its shuffle with the epoch number, so a resumed run
        sees the batches an uninterrupted one would. ``callbacks`` is
        accepted and not run, as in the JAX package: drive them by
        hand."""
        own_loader = not isinstance(train_data, DataLoader)
        loader = DataLoader(train_data, batch_size=batch_size,
                            shuffle=shuffle, drop_last=drop_last) \
            if own_loader else train_data
        device = self._device()
        start_epoch, skip = (0, 0) if not resume else \
            self._resume_point(resume, save_dir, verbose)
        if own_loader:
            loader._epoch = start_epoch
        run_epoch = self._fit_epoch_compiled if compiled \
            else self._fit_epoch_eager
        self._epoch_summaries = []
        with contextlib.ExitStack() as scope:
            if compiled:
                # restored on exit, so eager code outside fit stays the
                # unfused oracle; an explicit env/set_flags value wins
                scope.enter_context(flags.scoped_default(
                    "FLAGS_fused_linear_cross_entropy", True))
            for epoch in range(start_epoch, epochs):
                t0 = time.perf_counter()
                losses = run_epoch(loader, epoch, log_freq, verbose, device,
                                   skip if epoch == start_epoch else 0)
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
                if save_dir is not None and epoch % save_freq == 0:
                    if legacy_save:
                        self.save(f"{save_dir}/epoch_{epoch}")
                    self.save_checkpoint(f"{save_dir}/step_{epoch}",
                                         epoch=epoch,
                                         keep_last_n=keep_last_n)
                if eval_data is not None and epoch % eval_freq == 0:
                    self.evaluate(eval_data, batch_size=batch_size,
                                  verbose=verbose, compiled=compiled)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, compiled=True):
        """``{"loss": [mean over the batches]}``. ``compiled=True``: the
        losses stay on the device and are read once at the end (through
        the fused loss when the flag is on, as inside ``fit``);
        ``compiled=False``: ``eval_batch`` per batch. As in the JAX
        package, the prepared metrics are not computed here."""
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size)
        device = self._device()
        if compiled:
            pending = [self._eval_step(*_to(b, device)) for b in loader]
            losses = torch.stack(pending).tolist()
        else:
            losses = []
            for batch in loader:
                *xs, y = _to(batch, device)
                losses.append(self.eval_batch(xs, y)[0])
        result = {"loss": [float(np.mean(losses))]}
        if verbose:
            print(f"Eval loss: {result['loss'][0]:.5f}")
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """The network's outputs, one entry a batch."""
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size)
        device = self._device()
        return [self.predict_batch(_to(b, device)) for b in loader]

    def save(self, path, training=True):
        """``<path>.pdparams`` (the network's state dict) and, with
        ``training``, ``<path>.pdopt`` (the optimizer's)."""
        save_obj(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save_obj(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        device = self._device()
        self.network.load_state_dict(load_obj(path + ".pdparams",
                                              device=device))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(load_obj(path + ".pdopt",
                                                    device=device))

    def _checkpoint_state(self, epoch=None, mid_epoch_step=None):
        """Everything a resume needs: the network, the optimizer (slots,
        master weights, ``@step``, ``LR_Scheduler``), the scaler, the
        epoch and a mid-epoch step."""
        state = {"model": self.network.state_dict()}
        if self._optimizer is not None:
            state["optimizer"] = self._optimizer.state_dict()
        if self._scaler is not None:
            state["scaler"] = self._scaler.state_dict()
        if epoch is not None:
            state["epoch"] = int(epoch)
        if mid_epoch_step is not None:
            state["mid_epoch_step"] = int(mid_epoch_step)
        return state

    def save_checkpoint(self, path, epoch=None, keep_last_n=None,
                        mid_epoch_step=None):
        """Atomic checkpoint of :meth:`_checkpoint_state`: the directory
        appears committed or not at all (``distributed.checkpoint``)."""
        dckpt.save_state_dict(self._checkpoint_state(epoch, mid_epoch_step),
                              path, keep_last_n=keep_last_n)

    def load_checkpoint(self, path):
        """Validated load of a committed checkpoint (checksums verified; a
        torn or corrupt directory raises). Returns the epoch recorded at
        save time, or -1; a mid-epoch step lands in
        ``self._resume_mid_step`` (None otherwise)."""
        dckpt.load_state_dict({"model": self.network.state_dict()}, path)
        if self._optimizer is not None:
            # read, not loaded in place: the optimizer makes its slots at
            # its first step, so set_state_dict stashes what it reads
            opt_state = {}
            for k, v in dckpt.read_state_dict(path,
                                              prefix="optimizer").items():
                # one nested level (LR_Scheduler); slot names may hold
                # dots themselves
                if k.startswith("LR_Scheduler."):
                    opt_state.setdefault("LR_Scheduler", {})[
                        k[len("LR_Scheduler."):]] = v
                else:
                    opt_state[k] = v
            if opt_state:
                self._optimizer.set_state_dict(opt_state)
        vals = dckpt.load_values(path)
        if self._scaler is not None and isinstance(vals.get("scaler"),
                                                   dict):
            self._scaler.load_state_dict(vals["scaler"])
        mid = vals.get("mid_epoch_step")
        self._resume_mid_step = int(mid) if mid is not None else None
        return int(vals.get("epoch", -1))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        print(f"Total params: {n_params}")
        return {"total_params": n_params}


def _to(batch, device):
    batch = batch if isinstance(batch, (list, tuple)) else [batch]
    return [t.to(device, non_blocking=True) for t in batch]
