"""High-level Model API: ``prepare`` / ``fit`` / ``evaluate`` / ``predict``
/ ``save`` / ``load``.

Counterpart of ``paddle_tpu/hapi/model.py``. ``train_batch`` captures
the whole step (forward, loss, backward, ``optimizer.step()``,
``clear_grad()``) under ``FLAGS_step_capture``: after one eager probe and
one warm-up the step replays as one CUDA graph (``jit/step_capture.py``;
on the CPU its stand-in), and the network's outputs come back from the
same step. ``prepare(..., jit=True)`` trains through ``jit.TrainStep``
instead. ``fit`` under ``FLAGS_multi_step`` K > 1 trains each epoch in
K-step blocks: the DataLoader's prefetch thread stacks ``[K, ...]``
blocks (``fill_ring``), ONE graph trains a block, the loader's committed
stream state advances to the block's end, and only then do the per-step
callbacks run, in order, with the block's ``[K]`` losses read back once;
the epoch's K-misaligned tail runs single-step capture. Callbacks that
steer training between steps (``LRScheduler(by_step=True)``, a callback
overriding the per-batch hooks) keep fit on single steps, with the block
reason counted (``jit.multi_step.record_block_fallback``).

``prepare(metrics=...)`` takes ``paddle.metric`` metrics: each batch's
outputs (a captured step's too, and each step of a K-step block) go
through ``compute`` and ``update``, and the logs carry ``accumulate()``
under the metric's names; each epoch and each evaluation resets them.
Not ported: ``fit(resilience_dir=)`` needs ``distributed/resilience``
(ROADMAP A8(e)) and raises. Data that is not a DataLoader is wrapped in one on
the network's device.
"""

from __future__ import annotations

import os
import weakref
from typing import List, Optional

import numpy as np
import torch

from .. import flags as _flags
from . import callbacks as cbks_mod

__all__ = ["Model", "summary"]


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Model:
    """Network wrapper with train/eval/predict loops."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._loss = None
        self._metrics: List = []
        self._optimizer = None
        self._train_step = None    # jit.TrainStep when jit=True
        self._captured_step = None  # FLAGS_step_capture auto-capture
        self._multi_step = None    # FLAGS_multi_step K-block capture
        self._jit = False
        self._amp_level = None
        self.stop_training = False

    # -- mode -------------------------------------------------------------------
    @property
    def mode(self):
        return "train" if self.network.training else "eval"

    def train(self):
        self.network.train()

    def eval(self):
        self.network.eval()

    def _device(self) -> torch.device:
        for t in list(self.network.parameters()) + \
                list(self.network.buffers()):
            return t.device
        from ..core.device import resolve_device
        return resolve_device(None)

    def _tensor(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(self._device())

    # -- prepare ----------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=False):
        from ..metric import Metric
        metrics = _to_list(metrics)
        for m in metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m} is not a paddle.metric.Metric")
        if loss is not None and not callable(loss):
            raise TypeError("loss must be a Layer or a callable")
        self._optimizer = optimizer
        self._captured_step = None   # new opt/loss: stale capture closure
        self._multi_step = None
        self._train_step = None
        self._loss = loss
        self._metrics = metrics
        self._jit = bool(jit)
        if amp_configs not in (None, "O0", False):
            self._amp_level = amp_configs if isinstance(amp_configs, str) \
                else amp_configs.get("level", "O1")
        else:
            self._amp_level = None
        return self

    def _loss_value(self, outputs, labels):
        loss = self._loss(*outputs, *labels)
        if isinstance(loss, (list, tuple)):
            loss = loss[0]
        return loss

    # -- batch steps ------------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "train_batch")
        self.network.train()
        inputs = [self._tensor(x) for x in _to_list(inputs)]
        labels = [self._tensor(x) for x in _to_list(labels)]
        if self._jit and update:
            if self._train_step is None:
                from ..jit.api import TrainStep
                self._train_step = TrainStep(
                    self.network, self._scalar_loss, self._optimizer,
                    amp_level=self._amp_level)
            lv = float(self._train_step(tuple(inputs), tuple(labels)))
            if not self._metrics:
                return lv
            # TrainStep returns no outputs: one more forward for the
            # metrics, in eval mode (BatchNorm statistics and dropout
            # stay as the step left them)
            self.network.eval()
            try:
                with torch.no_grad():
                    outputs = _to_list(self.network(*inputs))
            finally:
                self.network.train()
            return self._with_metric_results(outputs, labels, [lv])
        if not update:     # loss only, no parameter change
            with torch.no_grad():
                outputs = self._forward_amp(inputs)
                lv = float(self._loss_value(outputs, labels))
            return self._with_metric_results(outputs, labels, [lv])
        if _flags.get_flag("step_capture"):
            if self._captured_step is None:
                from ..jit.step_capture import jit_step
                self._captured_step = jit_step(
                    self._eager_step_fn(), generators=self._generators())
            loss, outputs = self._captured_step(tuple(inputs),
                                                tuple(labels))
        else:
            loss, outputs = self._eager_step_fn()(tuple(inputs),
                                                  tuple(labels))
        return self._with_metric_results(outputs, labels, [float(loss)])

    def _with_metric_results(self, outputs, labels, losses):
        """The losses alone (one: a float) without metrics; with them,
        ``(losses, [each metric's update() result])`` after each metric's
        ``compute`` and ``update`` over this batch."""
        if not self._metrics:
            return losses if len(losses) != 1 else losses[0]
        vals = []
        for m in self._metrics:
            computed = m.compute(*_to_list(outputs), *labels)
            vals.append(m.update(*_to_list(computed)))
        return losses, vals

    def _update_logs(self, res):
        """The callbacks' logs of a batch result: "loss", and each
        metric's ``accumulate()`` under its names."""
        logs = {}
        if isinstance(res, tuple) and len(res) == 2 \
                and isinstance(res[0], list):
            losses, _ = res
            if losses:
                logs["loss"] = losses[0]
            for m in self._metrics:
                for n, v in zip(_to_list(m.name()), _to_list(m.accumulate())):
                    logs[n] = v
        elif isinstance(res, list):
            if res:
                logs["loss"] = res[0]
        else:
            logs["loss"] = res
        return logs

    def _metric_names(self):
        return ["loss"] + [n for m in self._metrics
                           for n in _to_list(m.name())]

    def _generators(self):
        """The generators the network's layers draw from (a ``Dropout``'s
        own): a captured step registers them."""
        from ..distributed.recompute import module_generators
        return module_generators(self.network)

    def _scalar_loss(self, *args):
        loss = self._loss(*args)
        if isinstance(loss, (list, tuple)):
            loss = loss[0]
        return loss

    def _eager_step_fn(self):
        """The whole-step closure both capture regimes run: one eager step
        (forward, loss, backward, ``step``, ``clear_grad``) returning
        ``(loss, outputs)``; ``jit_step`` captures it as it is,
        ``jit_step(k_steps=K)`` K times in one graph."""

        ref = weakref.ref(self)    # the capture it feeds must not hold
        #                            the Model (and so its graphs) back

        def _eager_step(ins, lbs):
            m = ref()
            outputs = m._forward_amp(list(ins))
            loss = m._loss_value(outputs, list(lbs))
            loss.backward()
            m._optimizer.step()
            m._optimizer.clear_grad()
            return loss.detach(), [o.detach() for o in outputs]

        return _eager_step

    def _forward_amp(self, inputs):
        if self._amp_level:
            from .. import amp as amp_mod
            with amp_mod.auto_cast(level=self._amp_level):
                return _to_list(self.network(*inputs))
        return _to_list(self.network(*inputs))

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = [self._tensor(x) for x in _to_list(inputs)]
        labels = [self._tensor(x) for x in _to_list(labels)]
        with torch.no_grad():
            outputs = self._forward_amp(inputs)
            losses = []
            if self._loss is not None and labels:
                losses.append(float(self._loss_value(outputs, labels)))
        if not self._metrics:
            return losses[0] if losses else []
        return self._with_metric_results(outputs, labels, losses)

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = [self._tensor(x) for x in _to_list(inputs)]
        with torch.no_grad():
            outputs = _to_list(self.network(*inputs))
        return [o.detach().cpu().numpy() for o in outputs]

    # -- data -------------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last):
        from ..io import DataLoader, Dataset
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, places=self._device(),
                              batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data   # any iterable of batches

    @staticmethod
    def _split_batch(batch, n_labels):
        batch = _to_list(batch)
        if n_labels and len(batch) > n_labels:
            return batch[:-n_labels], batch[-n_labels:]
        if len(batch) >= 2:
            return batch[:-1], batch[-1:]
        return batch, []

    # -- fit --------------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            resilience_dir=None, snapshot_steps=100):
        if train_data is None:
            raise ValueError("train_data must be given")
        if resilience_dir:
            raise NotImplementedError(
                "Model.fit(resilience_dir=...): distributed/resilience is "
                "not ported yet (ROADMAP A8(e))")
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers, drop_last)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers, False)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=self._metric_names())
        self.stop_training = False
        k_steps = self._multi_k(loader, cbks)
        cbks.on_train_begin()
        n_labels = len(self._labels)
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            if k_steps:
                logs = self._fit_epoch_multi(loader, cbks, n_labels,
                                             k_steps, logs)
            else:
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    ins, lbs = self._split_batch(batch, n_labels)
                    logs = self._update_logs(self.train_batch(ins, lbs))
                    cbks.on_train_batch_end(step, logs)
                    if self.stop_training:
                        break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self._run_eval(eval_loader, cbks, n_labels)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        return self

    # -- multi-step (K-blocks) --------------------------------------------------
    def _multi_k(self, loader, cbks) -> int:
        """K when ``FLAGS_multi_step`` can drive this fit in K-step blocks,
        else 0 (with the block reason counted)."""
        k = int(_flags.get_flag("multi_step"))
        if k <= 1 or self._jit or not _flags.get_flag("step_capture"):
            return 0
        from ..io import DataLoader, IterableDataset
        from ..jit.multi_step import record_block_fallback
        if not isinstance(loader, DataLoader) \
                or isinstance(loader.dataset, IterableDataset):
            record_block_fallback(
                "ring block shorter than k_steps (epoch tail)",
                "train_data is not a map-style DataLoader: no resumable "
                "ring to fill; the whole run is a tail")
            return 0
        unsafe = self._multi_unsafe_reason(cbks)
        if unsafe:
            record_block_fallback(
                "per-step host callbacks need single-step dispatch", unsafe)
            return 0
        return k

    def _multi_unsafe_reason(self, cbks) -> Optional[str]:
        """A block runs K steps before any host hook fires, and the
        per-step callbacks replay afterwards: safe for read-only
        observers, not for a hook that steers training between steps."""
        for c in cbks:
            if isinstance(c, cbks_mod.LRScheduler):
                if c.by_step:
                    return (f"{type(c).__name__}(by_step=True) steps the "
                            f"schedule between captured steps")
                continue
            if isinstance(c, cbks_mod.ProgBarLogger):
                continue
            if type(c).on_train_batch_begin is not \
                    cbks_mod.Callback.on_train_batch_begin \
                    or type(c).on_train_batch_end is not \
                    cbks_mod.Callback.on_train_batch_end:
                return f"{type(c).__name__} overrides per-step batch hooks"
        return None

    def _fit_epoch_multi(self, loader, cbks, n_labels, k, logs):
        """One epoch in K-step blocks (see the module docstring)."""
        from ..jit.multi_step import multi_counters

        def blocks():
            n = 0
            for b in loader.fill_ring(k):
                n += 1
                yield b
            if n == 0:
                # a restored cursor can sit exactly on an epoch boundary:
                # one empty resumed pass, then the next epoch
                yield from loader.fill_ring(k)

        step = 0
        for block in blocks():
            if block.stacked is not None:
                losses, outputs, lbs = self._train_block(block.stacked,
                                                         n_labels, k)
                loader._commit_stream_state(block.stream_state)
                for i in range(block.size):
                    cbks.on_train_batch_begin(step)
                    res = losses[i]
                    if self._metrics:    # each step's slice of the block
                        res = self._with_metric_results(
                            [o[i] for o in outputs], [y[i] for y in lbs],
                            [losses[i]])
                    logs = self._update_logs(res)
                    cbks.on_train_batch_end(step, logs)
                    step += 1
                    if self.stop_training:
                        break
            else:
                for batch in block.batches:
                    cbks.on_train_batch_begin(step)
                    ins, lbs = self._split_batch(batch, n_labels)
                    logs = self._update_logs(self.train_batch(ins, lbs))
                    loader._commit_stream_state(block.stream_state)
                    multi_counters["tail_steps"] += 1
                    cbks.on_train_batch_end(step, logs)
                    step += 1
                    if self.stop_training:
                        break
            if self.stop_training:
                break
        return logs

    def _train_block(self, stacked, n_labels, k):
        """One ``[K, ...]``-stacked block through the K-step graph: the
        per-step float losses (read back once), and the block's ``[K,
        ...]`` outputs and labels, which the metrics read step by step."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before fit")
        self.network.train()
        ins, lbs = self._split_batch(stacked, n_labels)
        ins = [self._tensor(x) for x in ins]
        lbs = [self._tensor(x) for x in lbs]
        if self._multi_step is None or self._multi_step.k_steps != k:
            from ..jit.step_capture import jit_step
            self._multi_step = jit_step(self._eager_step_fn(), k_steps=k,
                                        generators=self._generators())
        loss, outputs = self._multi_step(tuple(ins), tuple(lbs))
        return ([float(v) for v in loss.float().cpu().numpy()],
                _to_list(outputs), lbs)

    # -- eval / predict ----------------------------------------------------------
    def _run_eval(self, eval_loader, cbks, n_labels):
        cbks.on_eval_begin()
        for m in self._metrics:
            m.reset()
        logs = {}
        loss_sum, loss_n = 0.0, 0
        for step, batch in enumerate(eval_loader):
            cbks.on_eval_batch_begin(step)
            ins, lbs = self._split_batch(batch, n_labels)
            logs = self._update_logs(self.eval_batch(ins, lbs))
            if "loss" in logs:
                loss_sum += logs["loss"]
                loss_n += 1
            cbks.on_eval_batch_end(step, logs)
        if loss_n:   # the epoch-mean loss, not the last batch's
            logs["loss"] = loss_sum / loss_n
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._make_loader(eval_data, batch_size, False, num_workers,
                                   False)
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, log_freq=log_freq, verbose=verbose,
            metrics=self._metric_names(), mode="eval",
            steps=len(loader) if hasattr(loader, "__len__") else None)
        return self._run_eval(loader, cbks, len(self._labels))

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers,
                                   False)
        cbks = cbks_mod.config_callbacks(callbacks, model=self,
                                         verbose=verbose, mode="predict")
        cbks.on_predict_begin()
        outputs = []
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            ins = _to_list(batch)
            if self._inputs:
                ins = ins[:len(self._inputs)]
            elif self._labels:
                ins, _ = self._split_batch(batch, len(self._labels))
            else:
                ins = ins[:self._forward_arity(len(ins))]
            outputs.append(self.predict_batch(ins))
            cbks.on_predict_batch_end(step, {})
        cbks.on_predict_end()
        if stack_outputs and outputs:
            return [np.concatenate([b[i] for b in outputs], axis=0)
                    for i in range(len(outputs[0]))]
        return outputs

    def _forward_arity(self, have: int) -> int:
        import inspect
        try:
            sig = inspect.signature(self.network.forward)
        except (TypeError, ValueError):
            return have
        n = 0
        for p in sig.parameters.values():
            if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                return have
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                n += 1
        return min(have, n)

    # -- save / load --------------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (and ``path.pdopt`` with the optimizer's
        state) in the reference's format (``framework.save``)."""
        from ..framework import save as fsave
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Files of :meth:`save`, of the reference's ``Model.save`` or of
        upstream Paddle (``framework.load``), onto the model's device."""
        from ..framework import load as fload
        dev = self._device()
        params = {k: torch.from_numpy(np.asarray(
            v, np.float32) if v.dtype.name == "bfloat16" else v).to(dev)
            for k, v in fload(path + ".pdparams", return_numpy=True).items()}
        if skip_mismatch:
            own = self.network.state_dict()
            params = {k: v for k, v in params.items()
                      if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.network.load_state_dict(params, strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(fload(opt_path,
                                                 return_numpy=True))
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net: torch.nn.Module, input_size=None, dtype=None):
    """Layer-by-layer parameter summary; returns ``{'total_params': N,
    'trainable_params': N}`` and prints a table."""
    rows = []
    total = trainable = 0
    for name, sub in net.named_modules():
        own = list(sub.parameters(recurse=False))
        if not own:
            continue
        n = sum(p.numel() for p in own)
        rows.append((name or type(sub).__name__, type(sub).__name__, n))
        total += n
        trainable += sum(p.numel() for p in own if p.requires_grad)
    width = max([len(r[0]) for r in rows], default=10) + 2
    print(f"{'Layer':<{width}}{'Type':<24}{'Params':>12}")
    print("-" * (width + 36))
    for name, typ, n in rows:
        print(f"{name:<{width}}{typ:<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total:,}  Trainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
