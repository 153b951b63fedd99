"""GoogLeNet / Inception-v1 (reference python/paddle/vision/models/
googlenet.py) and Inception-v3 (inceptionv3.py)."""

from ... import nn
from ...ops.dispatcher import call_op

__all__ = ["GoogLeNet", "googlenet", "InceptionV3", "inception_v3"]


def _cb(in_c, out_c, k, stride=1, padding=0):
    return nn.Sequential(
        nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                  bias_attr=False),
        nn.BatchNorm2D(out_c), nn.ReLU())


class _Inception(nn.Layer):
    """v1 inception block: 1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _cb(in_c, c1, 1)
        self.b3 = nn.Sequential(_cb(in_c, c3r, 1), _cb(c3r, c3, 3,
                                                       padding=1))
        self.b5 = nn.Sequential(_cb(in_c, c5r, 1), _cb(c5r, c5, 5,
                                                       padding=2))
        self.bp = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _cb(in_c, proj, 1))

    def forward(self, x):
        return call_op(
            "concat", [self.b1(x), self.b3(x), self.b5(x), self.bp(x)], axis=1)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = nn.Sequential(
            _cb(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, padding=1),
            _cb(64, 64, 1), _cb(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4e(self.i4d(self.i4c(self.i4b(self.i4a(x)))))
        x = self.pool4(x)
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("googlenet: pretrained weights unavailable")
    return GoogLeNet(**kwargs)


# -- Inception v3 -------------------------------------------------------------

class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_c):
        super().__init__()
        self.b1 = _cb(in_c, 64, 1)
        self.b5 = nn.Sequential(_cb(in_c, 48, 1), _cb(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_cb(in_c, 64, 1), _cb(64, 96, 3, padding=1),
                                _cb(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _cb(in_c, pool_c, 1))

    def forward(self, x):
        return call_op(
            "concat", [self.b1(x), self.b5(x), self.b3(x), self.bp(x)], axis=1)


class _ReductionA(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _cb(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(_cb(in_c, 64, 1), _cb(64, 96, 3, padding=1),
                                 _cb(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return call_op(
            "concat", [self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _InceptionB(nn.Layer):
    """7x1/1x7 factorized block."""

    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _cb(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _cb(in_c, c7, 1), _cb(c7, c7, (1, 7), padding=(0, 3)),
            _cb(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _cb(in_c, c7, 1), _cb(c7, c7, (7, 1), padding=(3, 0)),
            _cb(c7, c7, (1, 7), padding=(0, 3)),
            _cb(c7, c7, (7, 1), padding=(3, 0)),
            _cb(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _cb(in_c, 192, 1))

    def forward(self, x):
        return call_op(
            "concat", [self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
            axis=1)


class _ReductionB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_cb(in_c, 192, 1), _cb(192, 320, 3,
                                                       stride=2))
        self.b7 = nn.Sequential(
            _cb(in_c, 192, 1), _cb(192, 192, (1, 7), padding=(0, 3)),
            _cb(192, 192, (7, 1), padding=(3, 0)),
            _cb(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return call_op(
            "concat", [self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _InceptionC(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _cb(in_c, 320, 1)
        self.b3r = _cb(in_c, 384, 1)
        self.b3a = _cb(384, 384, (1, 3), padding=(0, 1))
        self.b3b = _cb(384, 384, (3, 1), padding=(1, 0))
        self.bdr = nn.Sequential(_cb(in_c, 448, 1),
                                 _cb(448, 384, 3, padding=1))
        self.bda = _cb(384, 384, (1, 3), padding=(0, 1))
        self.bdb = _cb(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _cb(in_c, 192, 1))

    def forward(self, x):
        b3 = self.b3r(x)
        bd = self.bdr(x)
        return call_op("concat", [self.b1(x),
                       self.b3a(b3), self.b3b(b3),
                       self.bda(bd), self.bdb(bd),
                       self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = nn.Sequential(
            _cb(3, 32, 3, stride=2), _cb(32, 32, 3), _cb(32, 64, 3,
                                                         padding=1),
            nn.MaxPool2D(3, stride=2),
            _cb(64, 80, 1), _cb(80, 192, 3), nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _ReductionA(288),
            _InceptionB(768, 128), _InceptionB(768, 160),
            _InceptionB(768, 160), _InceptionB(768, 192),
            _ReductionB(768),
            _InceptionC(1280), _InceptionC(2048))
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("inception_v3: pretrained weights unavailable")
    return InceptionV3(**kwargs)
