"""hapi callbacks.

Counterpart of ``paddle_tpu/hapi/callbacks.py``: ``Callback``,
``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping``, ``ReduceLROnPlateau`` and ``config_callbacks`` (the
stack ``Model.fit`` builds by default: a ``ProgBarLogger`` when verbose,
an epoch ``LRScheduler``, and a ``ModelCheckpoint`` when ``save_dir`` is
given), the same code over the port's optimizer. ``ResilientCheckpoint``
waits for ``distributed/resilience`` (ROADMAP A8(e)).
"""

from __future__ import annotations

import numbers
import os
import time
import warnings
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
           "config_callbacks"]


class Callback:
    """Base callback: set_params/set_model + on_* event hooks."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    # mode-level
    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    # epoch-level
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    # batch-level
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, callback):
        self.callbacks.append(callback)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Console logger (reference ProgBarLogger, minus the curses bar:
    line-based so it behaves in redirected logs)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def _flush(self, prefix, step, logs):
        if self.verbose == 0:
            return
        metrics = self.params.get("metrics", [])
        parts = []
        for k in metrics:
            if k in (logs or {}):
                v = logs[k]
                if isinstance(v, (list, tuple, np.ndarray)):
                    v = " ".join(f"{float(x):.4f}" for x in np.ravel(v))
                elif isinstance(v, numbers.Number):
                    v = f"{float(v):.4f}"
                parts.append(f"{k}: {v}")
        steps = self.params.get("steps")
        total = f"/{steps}" if steps else ""
        print(f"{prefix} step {step}{total} - " + ", ".join(parts),
              flush=True)

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._train_step = 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.epoch_t0 = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}", flush=True)

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        if self.verbose == 2 and step % self.log_freq == 0:
            self._flush("train", step, logs)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self.epoch_t0
            self._flush(f"epoch {epoch + 1} done in {dt:.1f}s |", "end", logs)

    def on_eval_begin(self, logs=None):
        self.eval_t0 = time.time()
        if self.verbose:
            print("Eval begin...", flush=True)

    def on_eval_batch_end(self, step, logs=None):
        if self.verbose == 2 and step % self.log_freq == 0:
            self._flush("eval", step, logs)

    def on_eval_end(self, logs=None):
        if self.verbose:
            dt = time.time() - self.eval_t0
            self._flush(f"Eval done in {dt:.1f}s |", "end", logs)


class ModelCheckpoint(Callback):
    """Save model+optimizer every `save_freq` epochs and at train end
    (reference ModelCheckpoint)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference LRScheduler callback:
    by_step or by_epoch)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._lr, Sched):
            return opt._lr
        return None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    """Stop when `monitor` stops improving (reference EarlyStopping)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.wait_epoch = 0
        self.best_weights = None
        self.stopped_epoch = 0
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            warnings.warn(f"EarlyStopping mode {mode} unknown, using auto")
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in self.monitor
                             and "auc" not in self.monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater
            self.min_delta *= 1

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline
        else:
            self.best_value = np.inf if self.monitor_op == np.less \
                else -np.inf

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            warnings.warn(f"Monitor of EarlyStopping should be loss or "
                          f"metric name; {self.monitor} missing")
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple, np.ndarray)):
            current = float(np.ravel(current)[0])
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(os.path.join(self.params["save_dir"],
                                             "best_model"))
        else:
            self.wait_epoch += 1
        self.stopped_epoch += 1
        if self.wait_epoch > self.patience:
            self.model.stop_training = True
            if self.verbose > 0:
                print("Epoch %d: Early stopping." % self.stopped_epoch)


class ReduceLROnPlateau(Callback):
    """Multiply LR by `factor` when `monitor` plateaus (reference
    ReduceLROnPlateau callback)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau does not support a factor"
                             " >= 1.0")
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.wait = 0
        if mode == "min" or (mode == "auto" and "acc" not in monitor
                             and "auc" not in monitor):
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
            self.best = np.inf
        else:
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)
            self.best = -np.inf

    def on_eval_end(self, logs=None):
        from ..optimizer.lr import LRScheduler as Sched
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple, np.ndarray)):
            current = float(np.ravel(current)[0])
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.monitor_op(current, self.best):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                if isinstance(opt._lr, Sched):
                    # scale base_lr so the scheduler's own decay schedule
                    # keeps applying on top of the reduction (NOT
                    # base_lr = last_lr*factor, which would re-apply the
                    # accumulated decay on the next step())
                    sched = opt._lr
                    old = float(sched.last_lr)
                    sched.base_lr *= self.factor
                    sched.last_lr = max(old * self.factor, self.min_lr)
                    new = sched.last_lr
                else:
                    old = opt.get_lr()
                    new = max(old * self.factor, self.min_lr)
                    opt.set_lr(new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:g} -> {new:g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    """Assemble the default callback stack (reference config_callbacks)."""
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    params = {
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [], "save_dir": save_dir,
    }
    cbk_list.set_params(params)
    return cbk_list
