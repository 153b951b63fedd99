"""YOLOv3 with a DarkNet-53 backbone: the detection model of the zoo,
which trains through ``yolo_loss`` and predicts through ``yolo_box`` and
``multiclass_nms3``.

Counterpart of ``paddle_tpu/vision/models/yolov3.py``, with the same
parameter and buffer names; its structure is PaddleDetection's YOLOv3
(backbone -> 5-conv neck blocks -> per-scale heads).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ... import nn
from ...ops.dispatcher import call_op


class ConvBNLayer(nn.Layer):
    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)

    def forward(self, x):
        return call_op("leaky_relu", self.bn(self.conv(x)),
                       negative_slope=0.1)


class DarkNetBlock(nn.Layer):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = ConvBNLayer(ch, ch // 2, 1)
        self.conv2 = ConvBNLayer(ch // 2, ch, 3)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class DarkNet53(nn.Layer):
    """Returns features at strides 8/16/32 (C3, C4, C5)."""

    def __init__(self, depths: Sequence[int] = (1, 2, 8, 8, 4)):
        super().__init__()
        self.stem = ConvBNLayer(3, 32, 3)
        chans = [64, 128, 256, 512, 1024]
        stages = []
        cin = 32
        for ch, d in zip(chans, depths):
            blocks = [ConvBNLayer(cin, ch, 3, stride=2)]
            blocks += [DarkNetBlock(ch) for _ in range(d)]
            stages.append(nn.Sequential(*blocks))
            cin = ch
        self.stages = nn.LayerList(stages)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[2], feats[3], feats[4]          # C3, C4, C5


class YoloDetBlock(nn.Layer):
    """The 5-conv detection neck block + 3x3 route to the head."""

    def __init__(self, cin, ch):
        super().__init__()
        self.convs = nn.Sequential(
            ConvBNLayer(cin, ch, 1), ConvBNLayer(ch, ch * 2, 3),
            ConvBNLayer(ch * 2, ch, 1), ConvBNLayer(ch, ch * 2, 3),
            ConvBNLayer(ch * 2, ch, 1))
        self.tip = ConvBNLayer(ch, ch * 2, 3)

    def forward(self, x):
        route = self.convs(x)
        return route, self.tip(route)


class YOLOv3(nn.Layer):
    """3-scale YOLOv3. `forward` returns the raw per-scale head outputs
    (train targets for yolo_loss); `predict` decodes + NMS."""

    ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
               116, 90, 156, 198, 373, 326)
    ANCHOR_MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))

    def __init__(self, num_classes: int = 80,
                 backbone_depths: Sequence[int] = (1, 2, 8, 8, 4)):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = DarkNet53(backbone_depths)
        out_ch = 3 * (5 + num_classes)
        in_chs = (1024, 768, 384)        # C5, C4+route/2, C3+route/2
        chs = (512, 256, 128)
        self.blocks = nn.LayerList(
            [YoloDetBlock(cin, ch) for cin, ch in zip(in_chs, chs)])
        self.heads = nn.LayerList(
            [nn.Conv2D(ch * 2, out_ch, 1) for ch in chs])
        self.routes = nn.LayerList(
            [ConvBNLayer(chs[i], chs[i] // 2, 1) for i in range(2)])

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        outs = []
        feat = c5
        for i, (block, head) in enumerate(zip(self.blocks, self.heads)):
            route, tip = block(feat)
            outs.append(head(tip))
            if i < 2:
                r = self.routes[i](route)
                r = call_op("nearest_interp", r, scale_factor=2.0)
                feat = call_op("concat", [r, (c4 if i == 0 else c3)], axis=1)
        return outs                      # strides 32, 16, 8

    def loss(self, outs, gt_box, gt_label, gt_score=None,
             ignore_thresh: float = 0.7):
        total = None
        for i, (out, mask) in enumerate(zip(outs, self.ANCHOR_MASKS)):
            l, _, _ = call_op(
                "yolo_loss", out, gt_box, gt_label, gt_score,
                anchors=list(self.ANCHORS), anchor_mask=list(mask),
                class_num=self.num_classes, ignore_thresh=ignore_thresh,
                downsample_ratio=32 // (2 ** i))
            s = l.sum()
            total = s if total is None else total + s
        return total

    def predict(self, x, img_size, conf_thresh: float = 0.01,
                nms_thresh: float = 0.45, keep_top_k: int = 100):
        outs = self.forward(x)
        boxes, scores = [], []
        for i, (out, mask) in enumerate(zip(outs, self.ANCHOR_MASKS)):
            anchors = [self.ANCHORS[2 * m + d] for m in mask for d in (0, 1)]
            b, s = call_op("yolo_box", out, img_size, anchors=anchors,
                           class_num=self.num_classes,
                           conf_thresh=conf_thresh,
                           downsample_ratio=32 // (2 ** i))
            boxes.append(b)
            scores.append(s)
        boxes = call_op("concat", boxes, axis=1)         # [n, T, 4]
        scores = call_op("concat", scores, axis=1)       # [n, T, C]
        scores = call_op("transpose", scores, perm=[0, 2, 1])
        return call_op("multiclass_nms3", boxes, scores,
                       score_threshold=conf_thresh, nms_top_k=1000,
                       keep_top_k=keep_top_k, nms_threshold=nms_thresh,
                       background_label=-1)


def yolov3_darknet53(pretrained: bool = False, num_classes: int = 80,
                     **kwargs) -> YOLOv3:
    if pretrained:
        raise RuntimeError(
            "yolov3_darknet53: pretrained weights unavailable (not "
            "bundled); load a local state_dict via model.set_state_dict")
    return YOLOv3(num_classes=num_classes, **kwargs)
