"""SqueezeNet (reference python/paddle/vision/models/squeezenet.py)."""

from ... import nn
from ...ops.dispatcher import call_op

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class MakeFire(nn.Layer):
    def __init__(self, in_c, squeeze_c, e1_c, e3_c):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze_c, 1)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze_c, e1_c, 1)
        self.expand3 = nn.Conv2D(squeeze_c, e3_c, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return call_op("concat", [self.relu(self.expand1(x)),
                       self.relu(self.expand3(x))], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.conv1 = nn.Conv2D(3, 96, 7, stride=2)
            fires = [MakeFire(96, 16, 64, 64), MakeFire(128, 16, 64, 64),
                     MakeFire(128, 32, 128, 128), MakeFire(256, 32, 128, 128),
                     MakeFire(256, 48, 192, 192), MakeFire(384, 48, 192, 192),
                     MakeFire(384, 64, 256, 256), MakeFire(512, 64, 256, 256)]
            self._pool_after = {0: False, 2: True, 6: True}
        else:
            self.conv1 = nn.Conv2D(3, 64, 3, stride=2, padding=1)
            fires = [MakeFire(64, 16, 64, 64), MakeFire(128, 16, 64, 64),
                     MakeFire(128, 32, 128, 128), MakeFire(256, 32, 128, 128),
                     MakeFire(256, 48, 192, 192), MakeFire(384, 48, 192, 192),
                     MakeFire(384, 64, 256, 256), MakeFire(512, 64, 256, 256)]
            self._pool_after = {1: True, 3: True}
        self.fires = nn.LayerList(fires)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2)
        self.dropout = nn.Dropout(0.5)
        self.final_conv = nn.Conv2D(512, num_classes, 1)
        self.avgpool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.maxpool(self.relu(self.conv1(x)))
        for i, fire in enumerate(self.fires):
            x = fire(x)
            if self._pool_after.get(i):
                x = self.maxpool(x)
        x = self.relu(self.final_conv(self.dropout(x)))
        if self.with_pool:
            x = self.avgpool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("squeezenet1_0: pretrained weights unavailable")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("squeezenet1_1: pretrained weights unavailable")
    return SqueezeNet("1.1", **kwargs)
