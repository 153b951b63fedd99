"""``paddle.metric``: ``Metric``, ``Accuracy``, ``Precision``, ``Recall``
and ``Auc`` (counterpart of ``paddle_tpu/metric/__init__.py``).

``compute()`` runs on the predictions' device in torch (``Accuracy``'s
top-k correctness matrix); ``update()`` accumulates small numpy counts on
the host, the split Paddle's metrics draw between their compute and update
halves. ``hapi.Model.prepare(metrics=...)`` takes them.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def _plain(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        from ..core.tensor import unwrap
        return unwrap(x)
    return torch.as_tensor(np.asarray(x))


class Metric(metaclass=abc.ABCMeta):
    """Base class (reference metrics.py Metric): reset/update/accumulate/
    name, with an optional on-device compute() preprocessing stage."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Device-side preprocessing of (pred, label) -> update() inputs.
        Default: identity passthrough."""
        return args


class Accuracy(Metric):
    """Top-k accuracy (reference metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """pred: [N, C] scores; label: [N] or [N, 1] int or one-hot [N, C].
        Returns [N, maxk] float correctness matrix (on device)."""
        p = _plain(pred).detach()
        lab = _plain(label).detach().to(p.device)
        if p.dim() == 1:  # binary scores [N] -> two-column [N, 2]
            p = torch.stack([1.0 - p, p], dim=-1)
        if lab.dim() == p.dim() and lab.shape[-1] == p.shape[-1] \
                and lab.shape[-1] > 1:
            lab = torch.argmax(lab, dim=-1)  # one-hot -> index
        lab = lab.reshape(lab.shape[0], -1)[:, 0]
        k = min(self.maxk, p.shape[-1])
        _, topk_idx = torch.topk(p.float(), k, dim=-1)
        correct = (topk_idx == lab[:, None].long()).float()
        if k < self.maxk:  # pad so update() sees maxk columns
            correct = torch.nn.functional.pad(correct, (0, self.maxk - k))
        return correct

    def update(self, correct, *args):
        correct = _to_numpy(correct)
        num_samples = correct.shape[0]
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = correct[:, :k].max(axis=-1).sum()
            self.total[i] += num_corrects
            self.count[i] += num_samples
            accs.append(float(num_corrects) / num_samples
                        if num_samples else 0.0)
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0
               for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision = tp / (tp + fp) (reference metrics.py Precision).
    preds are probabilities of the positive class; threshold 0.5."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_numpy(preds).reshape(-1)
        labels = _to_numpy(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels != 1)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall = tp / (tp + fn) (reference metrics.py Recall)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_numpy(preds).reshape(-1)
        labels = _to_numpy(labels).reshape(-1)
        pred_pos = preds > 0.5
        actual_pos = labels == 1
        self.tp += int(np.sum(pred_pos & actual_pos))
        self.fn += int(np.sum(~pred_pos & actual_pos))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        ap = self.tp + self.fn
        return float(self.tp) / ap if ap != 0 else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via threshold-bucketed tp/fp histograms (reference
    metrics.py Auc, num_thresholds buckets, trapezoid rule)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_numpy(preds)
        labels = _to_numpy(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = (pos_prob * self._num_thresholds).astype(np.int64)
        bins = np.clip(bins, 0, self._num_thresholds)
        pos = labels >= 1
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def reset(self):
        n = self._num_thresholds + 1
        self._stat_pos = np.zeros(n, dtype=np.int64)
        self._stat_neg = np.zeros(n, dtype=np.int64)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        idx = self._num_thresholds
        while idx >= 0:
            tot_pos_prev = tot_pos
            tot_neg_prev = tot_neg
            tot_pos += float(self._stat_pos[idx])
            tot_neg += float(self._stat_neg[idx])
            auc += self.trapezoid_area(tot_neg, tot_neg_prev, tot_pos,
                                       tot_pos_prev)
            idx -= 1
        return auc / (tot_pos * tot_neg) if tot_pos > 0 and tot_neg > 0 \
            else 0.0

    def name(self):
        return self._name
