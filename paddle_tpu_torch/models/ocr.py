"""OCR models of the PP-OCR pipeline: ``DBNet`` + ``DBLoss`` (text
detection: a strided conv backbone, an FPN neck, the differentiable
binarization head) and ``CRNN`` + ``CTCHeadLoss`` (text recognition: a conv
stack pooled to one line, a 2-layer BiLSTM, per-column class logits
``[T, B, C]`` and the CTC loss).

Counterpart of ``paddle_tpu/models/ocr.py:21-209``, with the same
parameter and buffer names (the LSTM's ``weight_ih_l{k}[_reverse]``,
BatchNorm's ``_mean`` / ``_variance``), so ``models.from_jax_state_dict``
loads a reference model name for name.
"""

from __future__ import annotations

from typing import List

from .. import nn
from ..nn import functional as F
from ..ops.dispatcher import call_op


class _ConvBNLayer(nn.Layer):
    def __init__(self, cin, cout, k, stride=1, groups=1, act="hardswish"):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                              groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act:
            x = call_op(self.act, x)
        return x


class _DetBackbone(nn.Layer):
    """Lightweight 4-stage conv backbone (MobileNetV3-style strides) emitting
    pyramid features at 1/4, 1/8, 1/16, 1/32."""

    def __init__(self, in_channels=3, scale=0.5):
        super().__init__()
        c = [int(ch * scale) for ch in (32, 64, 128, 256, 512)]
        self.stem = _ConvBNLayer(in_channels, c[0], 3, stride=2)
        self.stage1 = nn.Sequential(
            _ConvBNLayer(c[0], c[1], 3, stride=2),
            _ConvBNLayer(c[1], c[1], 3, groups=1))
        self.stage2 = nn.Sequential(
            _ConvBNLayer(c[1], c[2], 3, stride=2),
            _ConvBNLayer(c[2], c[2], 3))
        self.stage3 = nn.Sequential(
            _ConvBNLayer(c[2], c[3], 3, stride=2),
            _ConvBNLayer(c[3], c[3], 3))
        self.stage4 = nn.Sequential(
            _ConvBNLayer(c[3], c[4], 3, stride=2),
            _ConvBNLayer(c[4], c[4], 3))
        self.out_channels = c[1:]

    def forward(self, x):
        x = self.stem(x)
        c2 = self.stage1(x)
        c3 = self.stage2(c2)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return [c2, c3, c4, c5]


class _DBFPN(nn.Layer):
    """FPN neck fusing the pyramid to a single 1/4-resolution map
    (PaddleOCR DBFPN)."""

    def __init__(self, in_channels: List[int], out_channels: int = 96):
        super().__init__()
        self.ins = [nn.Conv2D(c, out_channels, 1, bias_attr=False)
                    for c in in_channels]
        self.ps = [nn.Conv2D(out_channels, out_channels // 4, 3, padding=1,
                             bias_attr=False) for _ in in_channels]
        for i, (lat, sm) in enumerate(zip(self.ins, self.ps)):
            self.add_sublayer(f"in{i}", lat)
            self.add_sublayer(f"p{i}", sm)

    def forward(self, feats):
        laterals = [conv(f) for conv, f in zip(self.ins, feats)]
        # top-down pathway: upsample and add
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[2], laterals[i - 1].shape[3]
            up = F.interpolate(laterals[i], size=[h, w], mode="nearest")
            laterals[i - 1] = laterals[i - 1] + up
        outs = []
        h, w = laterals[0].shape[2], laterals[0].shape[3]
        for conv, lat in zip(self.ps, laterals):
            o = conv(lat)
            if o.shape[2] != h or o.shape[3] != w:
                o = F.interpolate(o, size=[h, w], mode="nearest")
            outs.append(o)
        return call_op("concat", outs, axis=1)


class _DBHead(nn.Layer):
    """Differentiable-binarization head: probability + threshold maps and
    the approximate binary map B = sigmoid(k (P - T))."""

    def __init__(self, in_channels: int, k: int = 50):
        super().__init__()
        self.k = k
        c = in_channels // 4

        def branch():
            return nn.Sequential(
                nn.Conv2D(in_channels, c, 3, padding=1, bias_attr=False),
                nn.BatchNorm2D(c), nn.ReLU(),
                nn.Conv2DTranspose(c, c, 2, stride=2),
                nn.BatchNorm2D(c), nn.ReLU(),
                nn.Conv2DTranspose(c, 1, 2, stride=2),
                nn.Sigmoid())

        self.prob = branch()
        self.thresh = branch()

    def forward(self, x):
        p = self.prob(x)
        t = self.thresh(x)
        b = call_op("sigmoid", self.k * (p - t))
        return {"maps": call_op("concat", [p, t, b], axis=1),
                "prob": p, "thresh": t, "binary": b}


class DBNet(nn.Layer):
    """DB text detector (det model of the PP-OCR pipeline)."""

    def __init__(self, in_channels: int = 3, scale: float = 0.5,
                 fpn_channels: int = 96):
        super().__init__()
        self.backbone = _DetBackbone(in_channels, scale)
        self.neck = _DBFPN(self.backbone.out_channels, fpn_channels)
        self.head = _DBHead(fpn_channels)

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))


class DBLoss(nn.Layer):
    """DB training loss: BCE on the probability map (hard-negative-balanced
    in the reference; plain BCE here), L1 on the threshold map inside text
    regions, dice on the binary map."""

    def __init__(self, alpha: float = 5.0, beta: float = 10.0,
                 eps: float = 1e-6):
        super().__init__()
        self.alpha, self.beta, self.eps = alpha, beta, eps

    def forward(self, preds, gt_prob, gt_thresh, gt_mask):
        p, t, b = preds["prob"], preds["thresh"], preds["binary"]
        bce = F.binary_cross_entropy(p, gt_prob)
        l1 = call_op("mean", call_op("abs", (t - gt_thresh) * gt_mask))
        inter = call_op("sum", b * gt_prob)
        union = call_op("sum", b) + call_op("sum", gt_prob) + self.eps
        dice = 1.0 - 2.0 * inter / union
        return bce + self.alpha * l1 + self.beta * dice


class CRNN(nn.Layer):
    """Conv-recurrent recognizer with CTC head (rec model of PP-OCR).

    Input [B, C, 32, W] → conv downsample to height 1 → BiLSTM over width →
    per-column class logits [T=W/4, B, num_classes]."""

    def __init__(self, in_channels: int = 3, num_classes: int = 97,
                 hidden_size: int = 96):
        super().__init__()
        self.convs = nn.Sequential(
            _ConvBNLayer(in_channels, 32, 3, act="relu"),
            nn.MaxPool2D(2, 2),                      # 16 x W/2
            _ConvBNLayer(32, 64, 3, act="relu"),
            nn.MaxPool2D(2, 2),                      # 8 x W/4
            _ConvBNLayer(64, 128, 3, act="relu"),
            _ConvBNLayer(128, 128, 3, act="relu"),
            nn.MaxPool2D([2, 1], [2, 1]),            # 4 x W/4
            _ConvBNLayer(128, 256, 3, act="relu"),
            nn.MaxPool2D([2, 1], [2, 1]),            # 2 x W/4
            _ConvBNLayer(256, 256, 2, act="relu"),
        )
        self.pool_to_line = nn.AdaptiveAvgPool2D([1, None])
        self.rnn = nn.LSTM(256, hidden_size, num_layers=2,
                           direction="bidirect", time_major=False)
        self.fc = nn.Linear(2 * hidden_size, num_classes)

    def forward(self, x):
        feat = self.convs(x)                      # [B, 256, h', W']
        feat = self.pool_to_line(feat)            # [B, 256, 1, W']
        feat = call_op("squeeze", feat, axis=2)   # [B, 256, W']
        feat = call_op("transpose", feat, perm=[0, 2, 1])   # [B, T, 256]
        out, _ = self.rnn(feat)
        logits = self.fc(out)                     # [B, T, classes]
        return call_op("transpose", logits, perm=[1, 0, 2])  # [T, B, C]


class CTCHeadLoss(nn.Layer):
    """CTC loss head for CRNN (paddle.nn.functional.ctc_loss)."""

    def __init__(self, blank: int = 0):
        super().__init__()
        self.blank = blank

    def forward(self, logits, labels, label_lengths):
        T, B = logits.shape[0], logits.shape[1]
        input_lengths = call_op("full", shape=[B], fill_value=T,
                                dtype="int32").to(logits.device)
        return F.ctc_loss(logits, labels, input_lengths, label_lengths,
                          blank=self.blank)
