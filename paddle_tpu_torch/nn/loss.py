"""Loss layers.

Counterpart of ``paddle_tpu/nn/loss.py:9-97``: ``CrossEntropyLoss``
(hard or soft labels, ``ignore_index``, class ``weight``,
``label_smoothing``), ``MSELoss``, ``L1Loss``, ``SmoothL1Loss``,
``NLLLoss``, ``BCELoss``, ``BCEWithLogitsLoss`` and ``KLDivLoss``, each
over the op of the same reduction in ``ops/kernels/nn.py``.
"""

from __future__ import annotations

from ..ops.kernels import nn as K
from .layer_base import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction, self.soft_label, self.axis = reduction, soft_label, \
            axis
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        if self.label_smoothing > 0.0 and not self.soft_label:
            n = input.shape[self.axis]
            soft = K.one_hot(label, n) * (1.0 - self.label_smoothing) \
                + self.label_smoothing / n
            return K.cross_entropy_mean(input, soft, soft_label=True,
                                        axis=self.axis,
                                        reduction=self.reduction)
        return K.cross_entropy_mean(input, label, soft_label=self.soft_label,
                                    ignore_index=self.ignore_index,
                                    axis=self.axis, weight=self.weight,
                                    reduction=self.reduction)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return K.mse_loss(input, label, reduction=self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return K.l1_loss(input, label, reduction=self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return K.smooth_l1_loss(input, label, reduction=self.reduction,
                                delta=self.delta)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return K.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return K.binary_cross_entropy(input, label, weight=self.weight,
                                      reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return K.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, pos_weight=self.pos_weight,
            reduction=self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction, self.log_target = reduction, log_target

    def forward(self, input, label):
        return K.kl_div(input, label, reduction=self.reduction,
                        log_target=self.log_target)


__all__ = ["BCELoss", "BCEWithLogitsLoss", "CrossEntropyLoss", "KLDivLoss",
           "L1Loss", "MSELoss", "NLLLoss", "SmoothL1Loss"]
