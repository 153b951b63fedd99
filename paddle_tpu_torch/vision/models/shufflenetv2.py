"""ShuffleNetV2 (reference python/paddle/vision/models/shufflenetv2.py)."""

from ... import nn
from ...ops.dispatcher import call_op

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512],
    0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}


def _shuffle(x, groups=2):
    return call_op("channel_shuffle", x, groups=groups)


def _conv_bn(in_c, out_c, k, stride=1, groups=1, act="relu"):
    layers = [nn.Conv2D(in_c, out_c, k, stride=stride, padding=k // 2,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(out_c)]
    if act == "relu":
        layers.append(nn.ReLU())
    elif act == "swish":
        layers.append(nn.Swish())
    return nn.Sequential(*layers)


class _InvertedResidual(nn.Layer):
    """Stride-1 unit: channel split -> right branch -> concat -> shuffle."""

    def __init__(self, channels, act):
        super().__init__()
        c = channels // 2
        self.branch = nn.Sequential(
            _conv_bn(c, c, 1, act=act),
            _conv_bn(c, c, 3, groups=c, act=None),
            _conv_bn(c, c, 1, act=act))
        self.half = c

    def forward(self, x):
        x1 = x[:, :self.half]
        x2 = x[:, self.half:]
        return _shuffle(call_op("concat", [x1, self.branch(x2)], axis=1))


class _InvertedResidualDS(nn.Layer):
    """Stride-2 unit: both branches downsample, channels double."""

    def __init__(self, in_c, out_c, act):
        super().__init__()
        c = out_c // 2
        self.left = nn.Sequential(
            _conv_bn(in_c, in_c, 3, stride=2, groups=in_c, act=None),
            _conv_bn(in_c, c, 1, act=act))
        self.right = nn.Sequential(
            _conv_bn(in_c, c, 1, act=act),
            _conv_bn(c, c, 3, stride=2, groups=c, act=None),
            _conv_bn(c, c, 1, act=act))

    def forward(self, x):
        return _shuffle(call_op("concat", [self.left(x), self.right(x)],
                                axis=1))


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        stage_out = _STAGE_OUT[scale]
        self.conv1 = _conv_bn(3, stage_out[0], 3, stride=2, act=act)
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        blocks = []
        in_c = stage_out[0]
        for stage, repeats in enumerate([4, 8, 4]):
            out_c = stage_out[stage + 1]
            blocks.append(_InvertedResidualDS(in_c, out_c, act))
            for _ in range(repeats - 1):
                blocks.append(_InvertedResidual(out_c, act))
            in_c = out_c
        self.blocks = nn.LayerList(blocks)
        self.conv_last = _conv_bn(in_c, stage_out[4], 1, act=act)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(stage_out[4], num_classes)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        for b in self.blocks:
            x = b(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _make(scale, pretrained, act="relu", **kwargs):
    if pretrained:
        raise RuntimeError("shufflenet_v2: pretrained weights unavailable")
    return ShuffleNetV2(scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _make(0.25, pretrained, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _make(0.33, pretrained, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _make(0.5, pretrained, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _make(1.0, pretrained, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _make(1.5, pretrained, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _make(2.0, pretrained, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _make(1.0, pretrained, act="swish", **kw)
