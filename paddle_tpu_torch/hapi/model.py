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
oracle. After each epoch ``_last_epoch_summary`` holds
``profiler.trace.epoch_summary``'s record (``epoch``, ``steps``,
``epoch_s``, ``avg_step_ms``, ``steps_per_s``) with ``seconds``,
``mean_loss``, ``input_wait_ms`` and ``goodput_frac``;
``_epoch_summaries`` keeps every epoch's of the last ``fit``.

AMP: ``amp_configs`` ``"O1"`` runs the forward and the loss under
``amp.auto_cast``; ``"O2"`` also casts the parameters with
``amp.decorate``. A ``GradScaler`` given to ``prepare`` scales the loss
and unscales, skips and updates around the optimizer's step.

Preemption (``fit(preemptible=)``, on by default with ``save_dir``): a
``PreemptionGuard`` turns SIGTERM into a flag that both epoch loops poll
at each step boundary; the loop stops, resolves its pending losses, and
``fit`` commits an emergency ``step_<epoch>`` checkpoint holding the
``mid_epoch_step``, then raises ``Preempted`` (an uncaught one exits 75,
which the elastic launcher relaunches). A resume skips the steps the
checkpoint holds: their batches are fetched and dropped.

Goodput: ``fit`` keeps a ``GoodputLedger`` (``save_dir/goodput.json``,
loaded on a resume so that restart rounds add up), the process's current
one for ``/statusz``, booking ``reshard`` (the resume's load),
``checkpoint_save``, ``emergency_save`` and ``input_wait`` (the time
``fit`` waits on the loader's ``next()``). The ``hapi/*``, ``elastic/*``
and ``restart/*`` metrics below go to the default registry.

``load`` reads the JAX package's ``.pdparams``/``.pdopt`` too
(``framework.io``), through ``convert``'s layout changes.

Under a fleet (tensor-parallel, data-parallel, ZeRO stage 1-3 groups)
every rank runs ``fit``. ``save_checkpoint`` is the multi-rank commit
protocol of ``distributed.checkpoint``: each rank writes its part of the
model, the optimizer's slots, master weights and ``@step``, and the
scaler, and the coordinator commits through the barrier on the
filesystem; the emergency checkpoint bounds that barrier by the guard's
``remaining()`` grace and runs no collective, so a dead peer leaves it
uncommitted within the grace instead of hanging. ``load_checkpoint``
reshards everything onto the current layout (another mp, dp or ZeRO
degree, or one process), so ``fit(resume=True)`` continues on a smaller
or larger layout. ``save``/``load`` write and read the ``.pdparams``/
``.pdopt`` an unsharded model writes: the state is gathered
(``distributed.sharding.full_state``, collectives) and the first rank
writes; ``load`` takes this rank's part. The goodput ledger is kept by
the first rank.

Not ported yet: the device prefetcher and steps in flight (ROADMAP A.4;
the JAX package's compiled step dispatches ahead, the port's eager step
runs in order).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import numpy as np
import torch

from ..amp import auto_cast, decorate
from ..distributed import checkpoint as dckpt
from ..distributed.fleet.elastic import Preempted, PreemptionGuard
from ..framework import flags
from .. import convert
from ..framework.io import read as read_obj
from ..framework.io import save as save_obj
from ..io import DataLoader
from ..profiler import flight_recorder as _frec
from ..profiler import goodput as _goodput
from ..profiler import metrics as _pmetrics
from ..profiler import trace as _trace
from ..utils import monitor

__all__ = ["Model"]

_REG = _pmetrics.get_registry()

_pmetrics.declare("hapi/input_wait_ms", "gauge",
                  "ms the fit loop waited on the loader's next() this "
                  "epoch")
_pmetrics.declare("hapi/avg_step_ms", "gauge",
                  "per-epoch mean train-step wall time (epoch summary)")
_pmetrics.declare("elastic/preempt_requested", "counter",
                  "preemption signals that reached the fit loop")
_pmetrics.declare("elastic/emergency_save_ms", "gauge",
                  "wall time of the bounded-time emergency checkpoint")
_pmetrics.declare("elastic/emergency_step", "gauge",
                  "epoch-relative step the emergency checkpoint "
                  "captured")
_pmetrics.declare("restart/round", "gauge",
                  "the launcher's PADDLE_RESTART_ROUND at resume")
_pmetrics.declare("restart/resume_epoch", "gauge",
                  "epoch training resumed at")
_pmetrics.declare("restart/resume_step", "gauge",
                  "first step consumed after a mid-epoch resume (0 = "
                  "epoch start)")


def _persist_ledger(ledger):
    """Persist the goodput ledger, best effort: a full disk on the
    bookkeeping file must not mask a ``Preempted`` in flight or fail a
    run that otherwise succeeded."""
    try:
        ledger.persist()
    except OSError as e:
        warnings.warn(f"goodput ledger persist failed ({e!r}); "
                      "continuing without on-disk goodput continuity")


class _Batches:
    """One epoch's batches for a fit loop: iterating yields ``(step,
    batch)`` from ``skip_to`` on (the earlier batches of a mid-epoch
    resume are fetched and dropped), adds the time each ``next()`` on
    the loader blocked to ``wait_s``, and stops at the step boundary
    where ``guard`` reports a preemption (``preempted``). ``last_step``
    is the last step handed out."""

    def __init__(self, loader, guard, skip_to):
        self._loader = loader
        self._guard = guard
        self._skip_to = skip_to
        self.wait_s = 0.0
        self.preempted = False
        self.last_step = skip_to - 1

    def __iter__(self):
        it = iter(self._loader)
        try:
            step = 0
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    self.wait_s += time.perf_counter() - t0
                if self._guard is not None and self._guard.requested():
                    self.preempted = True
                    return
                if step >= self._skip_to:
                    self.last_step = step
                    yield step, batch
                step += 1
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()   # a loader's workers stop with its generator


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
        self._goodput = None

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
                            guard=None, skip_to=0):
        """One epoch of the compiled step: each step's loss stays on the
        device until ``log_freq`` or the epoch's end. ``guard`` is polled
        at each step boundary: on a request the loop stops and resolves
        its pending losses (its only state in flight) before ``fit``
        checkpoints. Returns the losses and the epoch's ``_Batches``."""
        losses, pending = [], []

        def resolve():
            # the epoch's only host reads of the device
            if pending:
                for v in torch.stack(pending).tolist():
                    losses.append(v)
                    monitor.emit_step_metrics(epoch=epoch, loss=v)
                pending.clear()

        batches = _Batches(loader, guard, skip_to)
        for step, batch in batches:
            with _trace.trace_span("hapi/train_batch", cat="train",
                                   epoch=epoch, step=step, mode="compiled"):
                pending.append(self._train_step(*_to(batch, device)))
            if step % log_freq == 0:
                resolve()
                if verbose:
                    print(f"epoch {epoch} step {step}: loss "
                          f"{losses[-1]:.5f}")
        resolve()
        return losses, batches

    def _fit_epoch_eager(self, loader, epoch, log_freq, verbose, device,
                         guard=None, skip_to=0):
        """The eager oracle loop (a host read a step), with the compiled
        loop's preemption and skip contract."""
        losses = []
        batches = _Batches(loader, guard, skip_to)
        for step, batch in batches:
            *xs, y = _to(batch, device)
            with _trace.trace_span("hapi/train_batch", cat="train",
                                   epoch=epoch, step=step):
                losses.append(self.train_batch(xs, y)[0])
            monitor.emit_step_metrics(epoch=epoch, loss=losses[-1])
            if verbose and step % log_freq == 0:
                print(f"epoch {epoch} step {step}: loss {losses[-1]:.5f}")
        return losses, batches

    def _resume_point(self, resume, save_dir, verbose, ledger):
        """(first epoch, steps of it already done) after loading the
        checkpoint ``resume`` names: a path; ``True`` takes
        ``PADDLE_RESUME_CHECKPOINT``, else the newest valid ``step_N``
        under ``save_dir``. (0, 0) when there is none. The load is booked
        as ``reshard``; the ``restart/*`` gauges and a ``resume``
        flight-recorder event record the point."""
        path = resume if isinstance(resume, (str, os.PathLike)) else None
        if path is None:
            path = os.environ.get("PADDLE_RESUME_CHECKPOINT")
        if path is None and save_dir is not None:
            path = dckpt.latest_valid_checkpoint(save_dir)
        if not path:
            return 0, 0
        with ledger.measure("reshard"):
            epoch_done = self.load_checkpoint(path)
        mid = self._resume_mid_step
        # a checkpoint taken inside an epoch redoes that epoch from the
        # step after the last one it holds
        start, skip = (epoch_done + 1, 0) if mid is None \
            else (epoch_done, int(mid) + 1)
        _REG.gauge("restart/round").set(
            int(os.environ.get("PADDLE_RESTART_ROUND", "0")))
        _REG.gauge("restart/resume_epoch").set(start)
        _REG.gauge("restart/resume_step").set(skip)
        _frec.record_event("resume", epoch=start, step=skip,
                           checkpoint=str(path))
        if verbose:
            print(f"resuming from {path} (epoch {start}"
                  f"{f' step {skip}' if skip else ''})")
        return start, skip

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, resume=None, keep_last_n=None,
            legacy_save=True, compiled=True, preemptible=None):
        """Train for ``epochs`` over ``train_data`` (a ``Dataset``,
        batched here by a ``DataLoader`` with ``num_workers``, or a
        ``DataLoader``); batches move to the device of the network's
        parameters.

        ``save_dir``: after every ``save_freq``-th epoch a committed
        ``step_<epoch>`` checkpoint (``keep_last_n`` bounds how many
        stay) and, unless ``legacy_save=False``, ``epoch_<epoch>.pdparams``
        / ``.pdopt``; and ``goodput.json``. ``eval_data``: ``evaluate``
        after every ``eval_freq``-th epoch. ``resume=True`` restarts from
        the newest committed checkpoint (``PADDLE_RESUME_CHECKPOINT``,
        else the newest valid ``step_N`` under ``save_dir``),
        ``resume=<path>`` from that one; the epochs it holds are skipped,
        and after an emergency checkpoint the steps of its epoch too. A
        loader fit builds seeds its shuffle with the epoch number, so a
        resumed run sees the batches an uninterrupted one would.

        ``preemptible``: ``None`` (the default) guards the run whenever
        ``save_dir`` is set, ``True`` too (and raises ``ValueError``
        without ``save_dir``: an emergency checkpoint needs somewhere to
        commit), ``False`` never, and a ``PreemptionGuard`` instance is
        used as given (shared across loops). On a request the loop
        stops at the next step boundary, commits ``step_<epoch>`` with
        its ``mid_epoch_step`` and raises ``Preempted(checkpoint=,
        epoch=, step=)``, the step relative to the epoch.

        ``callbacks`` is accepted and not run, as in the JAX package:
        drive them by hand."""
        if preemptible is True and save_dir is None:
            raise ValueError(
                "fit(preemptible=True) needs save_dir=: an emergency "
                "checkpoint has nowhere to commit")
        own_loader = not isinstance(train_data, DataLoader)
        loader = DataLoader(train_data, batch_size=batch_size,
                            shuffle=shuffle, drop_last=drop_last,
                            num_workers=num_workers) \
            if own_loader else train_data
        device = self._device()
        # restart rounds accumulate into one ledger beside the
        # checkpoints; a fresh fit into a reused save_dir starts anew
        ledger = _goodput.GoodputLedger(
            path=f"{save_dir}/goodput.json" if save_dir and _rank() == 0
            else None, load=bool(resume))
        self._goodput = ledger
        _goodput.set_current(ledger)
        guard, own_guard = None, False
        run_epoch = self._fit_epoch_compiled if compiled \
            else self._fit_epoch_eager
        self._epoch_summaries = []
        with contextlib.ExitStack() as scope:
            scope.callback(_persist_ledger, ledger)
            # frozen at the end: a later read must not book idle time
            scope.callback(ledger.close)
            start_epoch, skip = (0, 0) if not resume else \
                self._resume_point(resume, save_dir, verbose, ledger)
            if own_loader:
                loader._seed_epochs_from(start_epoch)
            if preemptible is not None and not isinstance(preemptible,
                                                          bool):
                guard = preemptible.install()
            elif preemptible is not False and save_dir is not None:
                guard, own_guard = PreemptionGuard().install(), True
            if own_guard:
                scope.callback(guard.uninstall)
            if compiled:
                # restored on exit, so eager code outside fit stays the
                # unfused oracle; an explicit env/set_flags value wins
                scope.enter_context(flags.scoped_default(
                    "FLAGS_fused_linear_cross_entropy", True))
            for epoch in range(start_epoch, epochs):
                t0 = time.perf_counter()
                losses, batches = run_epoch(
                    loader, epoch, log_freq, verbose, device, guard,
                    skip if epoch == start_epoch else 0)
                seconds = time.perf_counter() - t0
                wait_s = batches.wait_s
                ledger.add("input_wait", wait_s)
                _REG.gauge("hapi/input_wait_ms").set(
                    round(wait_s * 1e3, 3), epoch=epoch)
                summary = _trace.epoch_summary(
                    epoch, steps=len(losses), seconds=seconds,
                    mean_loss=float(np.mean(losses)) if losses else None,
                    input_wait_ms=round(wait_s * 1e3, 3),
                    goodput_frac=ledger.summary()["goodput_frac"])
                summary["seconds"] = seconds
                self._last_epoch_summary = summary
                self._epoch_summaries.append(summary)
                if batches.preempted:
                    step = batches.last_step
                    ck = self._emergency_checkpoint(save_dir, epoch, step,
                                                    keep_last_n, guard)
                    _persist_ledger(ledger)
                    raise Preempted(
                        f"preempted at epoch {epoch} step {step}; "
                        f"emergency checkpoint committed at {ck}",
                        checkpoint=ck, epoch=epoch, step=step)
                if verbose:
                    print(f"epoch {epoch} done: {summary['steps']} steps in "
                          f"{seconds:.2f}s (avg {summary['avg_step_ms']:.1f} "
                          f"ms/step)")
                if save_dir is not None and epoch % save_freq == 0:
                    with ledger.measure("checkpoint_save"):
                        if legacy_save:
                            self.save(f"{save_dir}/epoch_{epoch}")
                        self.save_checkpoint(f"{save_dir}/step_{epoch}",
                                             epoch=epoch,
                                             keep_last_n=keep_last_n)
                    _persist_ledger(ledger)
                if eval_data is not None and epoch % eval_freq == 0:
                    self.evaluate(eval_data, batch_size=batch_size,
                                  verbose=verbose, compiled=compiled)

    def _emergency_checkpoint(self, save_dir, epoch, step, keep_last_n,
                              guard=None):
        """The preemption checkpoint at a step boundary: the loop's
        pending losses are resolved, so the state is exactly that after
        step ``step`` of ``epoch``. Returns the committed path (None
        without ``save_dir``). The commit barrier gets the guard's
        remaining grace, not the default 300 s: a multi-rank save that
        cannot complete fails uncommitted before the SIGKILL."""
        _REG.counter("elastic/preempt_requested").inc()
        _frec.record_event("preempt_requested", epoch=epoch, step=step)
        if save_dir is None:
            return None
        t0 = time.perf_counter()
        path = f"{save_dir}/step_{epoch}"
        bound = guard.remaining() if guard is not None else None
        if bound is not None and not np.isfinite(bound):
            bound = None
        self.save_checkpoint(path, epoch=epoch, keep_last_n=keep_last_n,
                             mid_epoch_step=step, barrier_timeout=bound)
        elapsed = time.perf_counter() - t0
        if self._goodput is not None:
            self._goodput.add("emergency_save", elapsed)
        _REG.gauge("elastic/emergency_save_ms").set(round(elapsed * 1e3, 3))
        _REG.gauge("elastic/emergency_step").set(int(step), epoch=epoch)
        return path

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, compiled=True):
        """``{"loss": [mean over the batches]}``. ``compiled=True``: the
        losses stay on the device and are read once at the end (through
        the fused loss when the flag is on, as inside ``fit``);
        ``compiled=False``: ``eval_batch`` per batch. As in the JAX
        package, the prepared metrics are not computed here."""
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
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
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        device = self._device()
        return [self.predict_batch(_to(b, device)) for b in loader]

    def save(self, path, training=True):
        """``<path>.pdparams`` (the network's state dict) and, with
        ``training``, ``<path>.pdopt`` (the optimizer's), at the unsharded
        model's shapes: a sharded state is gathered and the first rank
        writes; with more than one rank every rank calls ``save`` and
        returns once the files are there (collectives)."""
        from ..distributed import env
        from ..distributed.communication import barrier
        from ..distributed.sharding import full_state
        state, opt_state = full_state(
            self.network, self._optimizer if training else None)
        if _rank() == 0:
            save_obj(state, path + ".pdparams")
            if opt_state is not None:
                save_obj(opt_state, path + ".pdopt")
        if env._dist_ready() and env.get_world_size() > 1:
            barrier()

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """The network's and optimizer's state from ``<path>.pdparams``/
        ``.pdopt``, written by this program or by the JAX package: a JAX
        file goes through ``convert.from_numpy_state_dict``/
        ``from_numpy_optimizer_state``, which turn Paddle's [in, out]
        Linear weights (and their slots) into torch's [out, in]."""
        from ..distributed.checkpoint.metadata import layout_of, local_part
        from ..distributed.fleet.base import current_hcg
        device = self._device()
        state, origin = read_obj(path + ".pdparams",
                                 return_numpy=None, device=device)
        if origin == "jax":
            convert.from_numpy_state_dict(self.network, state,
                                          hcg=current_hcg())
        else:
            # this rank's part of each full tensor
            target = self.network.state_dict()
            self.network.load_state_dict(
                {k: local_part(v, layout_of(target[k])) if k in target
                 else v for k, v in state.items()})
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            opt, origin = read_obj(path + ".pdopt", return_numpy=None,
                                   device=device)
            if origin == "jax":
                opt = convert.from_numpy_optimizer_state(self.network, opt)
            self._optimizer.set_state_dict(opt)

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
                        mid_epoch_step=None, barrier_timeout=None):
        """Atomic checkpoint of :meth:`_checkpoint_state`: the directory
        appears committed or not at all (``distributed.checkpoint``; every
        rank calls it, each writing its part). ``barrier_timeout`` bounds
        the commit barrier (the preemption grace window)."""
        dckpt.save_state_dict(self._checkpoint_state(epoch, mid_epoch_step),
                              path, keep_last_n=keep_last_n,
                              barrier_timeout=barrier_timeout)

    def load_checkpoint(self, path):
        """Validated load of a committed checkpoint (checksums verified; a
        torn or corrupt directory raises), resharding the network, the
        optimizer's slots, master weights and ``@step``, and the scaler
        onto the current layout: each rank reads the shards that overlap
        its part. Returns the epoch recorded at save time, or -1; a
        mid-epoch step lands in ``self._resume_mid_step`` (None
        otherwise)."""
        dckpt.load_state_dict({"model": self.network.state_dict()}, path)
        if self._optimizer is not None:
            # read, not loaded in place: the optimizer makes its slots at
            # its first step, so set_state_dict stashes what it reads
            opt_state = {}
            for k, v in dckpt.read_state_dict(
                    path, prefix="optimizer",
                    like=_state_part(self._optimizer)).items():
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


def _rank():
    """This process's rank in the joined process group (0 without one)."""
    from ..distributed import env
    return env.get_rank() if env._dist_ready() else 0


def _state_part(optimizer):
    """``read_state_dict``'s ``like`` for ``optimizer``'s state: a slot or
    master weight of a parameter this rank steps is read as that
    parameter's part (its shape and layout); the state of a parameter a
    ZeRO stage-1/2 peer owns is left out; other tensors are read
    whole."""
    from ..distributed.checkpoint.metadata import boxes, layout_of
    from ..distributed.fleet.hybrid_optimizer import base_optimizer
    from ..distributed.sharding import _sharding_optimizer
    base = base_optimizer(optimizer)
    zero = _sharding_optimizer(optimizer)
    owned = None if zero is None else {id(p)
                                       for p in zero.owned_parameters()}

    def like(key, global_shape):
        p = base._param_of(key)
        if p is None:
            return None
        if owned is not None and id(p) not in owned:
            return False
        if tuple(boxes(p)[0]) == tuple(global_shape):
            return tuple(p.shape), layout_of(p)
        return None
    return like


def _to(batch, device):
    """A batch as a list of its parts, each moved to ``device``: tensors
    inside dicts, lists and tuples too (a collate's nested output)."""
    batch = batch if isinstance(batch, (list, tuple)) else [batch]
    return [_move(b, device) for b in batch]


def _move(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if isinstance(obj, dict):
        return {k: _move(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_move(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(v, device) for v in obj)
    return obj
