"""AlexNet (reference python/paddle/vision/models/alexnet.py)."""

from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(dropout), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("alexnet: pretrained weights unavailable "
                           "(not bundled)")
    return AlexNet(**kwargs)
