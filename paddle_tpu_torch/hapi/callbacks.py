"""hapi callbacks: a port of ``paddle_tpu/hapi/callbacks.py``.

``Callback``, ``ProgBarLogger``, ``ModelCheckpoint`` (a committed
``step_{epoch}`` checkpoint by default), ``EarlyStopping``,
``LRScheduler`` and ``ReduceLROnPlateau``. As in the JAX package,
``Model.fit`` accepts ``callbacks`` and does not run them: a caller
drives them (``set_model``, then the ``on_*`` hooks). ``VisualDL`` and
``WandbCallback`` are not ported yet.
"""

from __future__ import annotations

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            print(f"step {step}: {logs}")


class ModelCheckpoint(Callback):
    """Epoch-end checkpointing. By default saves a *committed*
    ``step_{epoch}`` distributed checkpoint (atomic commit protocol:
    model + optimizer + epoch; a crash mid-save never leaves a
    loadable-but-wrong dir) that ``Model.fit(resume=True)`` can
    auto-resume from, with ``keep_last_n`` retention. ``atomic=False``
    restores the legacy ``model.save(f"{dir}/{epoch}")`` behavior."""

    def __init__(self, save_freq=1, save_dir=None, keep_last_n=None,
                 atomic=True):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.keep_last_n = keep_last_n
        self.atomic = atomic

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and epoch % self.save_freq == 0:
            if self.atomic and hasattr(self.model, "save_checkpoint"):
                self.model.save_checkpoint(
                    f"{self.save_dir}/step_{epoch}", epoch=epoch,
                    keep_last_n=self.keep_last_n)
            else:
                self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.best = None
        self.wait = 0
        self.stopped = False

    def on_eval_end(self, logs=None):
        if not logs or self.monitor not in logs:
            return
        v = logs[self.monitor]
        v = v[0] if isinstance(v, (list, tuple)) else v
        if self.best is None or v < self.best:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class ReduceLROnPlateau(Callback):
    """Drop LR when a monitored metric plateaus (hapi parity)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.mode = mode
        self._best = None
        self._bad = 0
        self._cool = 0

    def _better(self, cur):
        if self._best is None:
            return True
        if self.mode == "max":
            return cur > self._best + self.min_delta
        return cur < self._best - self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cool > 0:
            self._cool -= 1
        if self._better(cur):
            self._best = cur
            self._bad = 0
            return
        if self._cool > 0:
            return
        self._bad += 1
        if self._bad > self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                lr = opt.get_lr()
                new = max(lr * self.factor, self.min_lr)
                if new < lr:
                    opt.set_lr(new)
            self._bad = 0
            self._cool = self.cooldown
