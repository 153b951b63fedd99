"""DenseNet (reference python/paddle/vision/models/densenet.py)."""

from ... import nn
from ...ops.dispatcher import call_op

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {121: (64, 32, [6, 12, 24, 16]),
        161: (96, 48, [6, 12, 36, 24]),
        169: (64, 32, [6, 12, 32, 32]),
        201: (64, 32, [6, 12, 48, 32]),
        264: (64, 32, [6, 12, 64, 48])}


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c)
        self.conv1 = nn.Conv2D(in_c, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return call_op("concat", [x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c)
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False)
        self.relu = nn.ReLU()
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        assert layers in _CFG, f"layers must be one of {sorted(_CFG)}"
        num_init, growth, blocks = _CFG[layers]
        self.conv1 = nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(num_init)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        feats = []
        c = num_init
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, dropout))
                c += growth
            if i != len(blocks) - 1:
                feats.append(_Transition(c, c // 2))
                c //= 2
        self.features = nn.LayerList(feats)
        self.bn_final = nn.BatchNorm2D(c)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for layer in self.features:
            x = layer(x)
        x = self.relu(self.bn_final(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _make(layers, pretrained, **kwargs):
    if pretrained:
        raise RuntimeError(f"densenet{layers}: pretrained weights unavailable")
    return DenseNet(layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _make(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _make(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _make(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _make(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _make(264, pretrained, **kwargs)
