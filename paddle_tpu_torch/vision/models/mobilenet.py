"""MobileNet V1/V2/V3 (reference python/paddle/vision/models/
mobilenetv{1,2,3}.py) — depthwise-separable convs; V3 adds SE + hardswish.
"""

from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
           "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act="relu"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                              groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = {"relu": nn.ReLU(), "relu6": nn.ReLU6(),
                    "hardswish": nn.Hardswish(), None: nn.Identity()}[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, num_groups, stride, scale):
        super().__init__()
        self.dw = ConvBNLayer(int(in_c * scale), int(out_c1 * scale), 3,
                              stride=stride, padding=1,
                              groups=int(num_groups * scale))
        self.pw = ConvBNLayer(int(out_c1 * scale), int(out_c2 * scale), 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1)
        cfg = [  # in, c1, c2, groups, stride
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, c1, c2, g, s, scale) for i, c1, c2, g, s in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1, act="relu6"))
        layers += [
            ConvBNLayer(hidden_dim, hidden_dim, 3, stride=stride, padding=1,
                        groups=hidden_dim, act="relu6"),
            ConvBNLayer(hidden_dim, oup, 1, act=None),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        features = [ConvBNLayer(3, input_channel, 3, stride=2, padding=1,
                                act="relu6")]
        for t, c, n, s in cfg:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1, t))
                input_channel = output_channel
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features.append(ConvBNLayer(input_channel, self.last_channel, 1,
                                    act="relu6"))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


class SqueezeExcitation(nn.Layer):
    def __init__(self, input_c, squeeze_c):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(input_c, squeeze_c, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze_c, input_c, 1)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


class InvertedResidualV3(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp_c != in_c:
            layers.append(ConvBNLayer(in_c, exp_c, 1, act=act))
        layers.append(ConvBNLayer(exp_c, exp_c, k, stride=stride,
                                  padding=k // 2, groups=exp_c, act=act))
        if use_se:
            layers.append(SqueezeExcitation(exp_c, _make_divisible(exp_c // 4)))
        layers.append(ConvBNLayer(exp_c, out_c, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        if self.use_res:
            out = out + x
        return out


_V3_SMALL = [  # k, exp, out, se, act, stride
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]

_V3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, last_channel, scale=1.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        layers = [ConvBNLayer(3, in_c, 3, stride=2, padding=1, act="hardswish")]
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            layers.append(InvertedResidualV3(in_c, exp_c, out_c, k, s, se, act))
            in_c = out_c
        exp_c = _make_divisible(last_exp * scale)
        layers.append(ConvBNLayer(in_c, exp_c, 1, act="hardswish"))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(exp_c, last_channel), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_SMALL, 576, 1024, scale, num_classes, with_pool)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_LARGE, 960, 1280, scale, num_classes, with_pool)


def _no_pretrained(name, pretrained):
    if pretrained:
        raise RuntimeError(f"{name}: pretrained weights unavailable "
                           f"(not bundled)")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v1", pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v2", pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v3_small", pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v3_large", pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
