"""Common layers.

Counterpart of ``paddle_tpu/nn/layers_common.py:20-504``: ``Identity``,
``Linear`` (Paddle's ``[in, out]`` weight, ``x @ W + b``), ``Embedding``
(``padding_idx``), ``Conv1D`` / ``Conv2D`` / ``Conv2DTranspose``,
``LayerNorm``, ``RMSNorm``, ``BatchNorm1D/2D/3D``, ``GroupNorm``,
``InstanceNorm2D``, ``Dropout`` / ``Dropout2D``, the activation layers,
``LeakyReLU``, ``PReLU``, the pools, ``Flatten``, ``Upsample``,
``Pad2D``, ``PixelShuffle``, and the containers ``Sequential``,
``LayerList`` and ``ParameterList``. Each layer holds its parameters and
runs the op of the same name in ``ops/kernels/nn.py`` (the op choke
point). The same names and layouts as the reference, so a reference
``state_dict`` loads name for name (``models.convert``).

The Llama and MoE models build their ``Linear`` and ``Embedding`` from
here, with their seeded ``ParamInit`` as ``weight_attr`` and
``bias_attr=False``; ``nn/quant.py`` swaps ``Linear``s for
``WeightOnlyLinear``s, bias included.

Differences from the reference, by design:

- ``BatchNorm``'s running statistics follow Paddle: ``momentum=0.9``
  keeps 0.9 of the old value, and the variance kept is the biased batch
  variance the op returns (``F.batch_norm`` would store torch's momentum
  and the unbiased one); they are float32 buffers ``_mean`` /
  ``_variance``, updated in place (so a captured step updates them);
- ``Dropout`` draws its mask from an explicit generator on the layer's
  device: its own (seeded from the port's generator, ``initializer.seed``)
  or one the caller passes; never from torch's global generator. ``axis``
  shares a mask value along the other axes; ``Dropout2D`` is elementwise,
  as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import layer_device
from ..ops.kernels import nn as K
from . import initializer as I
from .layer_base import Layer, Parameter


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """``x @ W + b`` with ``W [in, out]`` (the reference's ``nn.Linear``;
    the default weight XavierNormal, the bias zeros, ``bias_attr=False``
    none)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter((out_features,), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return K.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Layer):
    """Rows of ``weight [num_embeddings, embedding_dim]``; ``padding_idx``
    rows come out zero and take no grad."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.padding_idx, self.sparse = padding_idx, sparse
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.XavierNormal())

    def forward(self, x):
        return K.embedding(x, self.weight, padding_idx=self.padding_idx)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _bias(layer, n, attr):
    return layer.create_parameter((n,), attr=attr, is_bias=True)


class Conv2D(Layer):
    """NCHW convolution, kernel ``[out, in/groups, kh, kw]``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        kh, kw = _pair(kernel_size)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, kh, kw), attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=in_channels // groups * kh * kw))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        return K.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv1D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, k), attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=in_channels // groups * k))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        return K.conv1d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv2DTranspose(Layer):
    """Kernel ``[in, out/groups, kh, kw]``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.output_padding, self.groups = output_padding, groups
        kh, kw = _pair(kernel_size)
        self.weight = self.create_parameter(
            (in_channels, out_channels // groups, kh, kw), attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=in_channels * kh * kw))
        self.bias = _bias(self, out_channels, bias_attr)

    def forward(self, x):
        return K.conv2d_transpose(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            dilation=self.dilation, groups=self.groups)


# -- normalization ------------------------------------------------------------

def _ones_or_none(layer, shape, attr):
    if attr is False:
        return None
    return layer.create_parameter(
        shape, default_initializer=I.Constant(1.0),
        attr=None if attr in (None, True) else attr)


def _zeros_or_none(layer, shape, attr):
    if attr is False:
        return None
    return layer.create_parameter(
        shape, is_bias=True, attr=None if attr in (None, True) else attr)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = _ones_or_none(self, self.normalized_shape, weight_attr)
        self.bias = _zeros_or_none(self, self.normalized_shape, bias_attr)

    def forward(self, x):
        return K.layer_norm(x, self.weight, self.bias, epsilon=self.epsilon,
                            begin_norm_axis=-len(self.normalized_shape))


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-06, weight_attr=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), default_initializer=I.Constant(1.0),
            attr=weight_attr)

    def forward(self, x):
        return K.rms_norm(x, self.weight, None, epsilon=self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = "NCHW" if data_format in ("NCHW", "NCL",
                                                     "NCDHW") else "NHWC"
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_features,),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter((num_features,), is_bias=True)
        dev = layer_device()
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        if self.training and not self.use_global_stats:
            out, mean, var = K.batch_norm_train(
                x, self.weight, self.bias, epsilon=self.epsilon,
                data_format=self.data_format)
            m = self.momentum
            with torch.no_grad():
                self._mean.copy_(self._mean * m + mean.float() * (1 - m))
                self._variance.copy_(self._variance * m
                                     + var.float() * (1 - m))
            return out
        return K.batch_norm_infer(x, self._mean, self._variance, self.weight,
                                  self.bias, epsilon=self.epsilon,
                                  data_format=self.data_format)


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_channels,),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter((num_channels,), is_bias=True)

    def forward(self, x):
        return K.group_norm(x, self.weight, self.bias, epsilon=self.epsilon,
                            groups=self.num_groups,
                            data_format=self.data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_features,),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter((num_features,), is_bias=True)

    def forward(self, x):
        return K.instance_norm(x, self.weight, self.bias,
                               epsilon=self.epsilon)


# -- dropout and activations --------------------------------------------------

class Dropout(Layer):
    """``Dropout(p, axis, mode)``; ``generator`` (on the layer's device)
    is the mask's source, by default one of the layer's own."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator if generator is not None \
            else _fresh_generator(layer_device())

    def forward(self, x):
        return K.dropout(x, p=self.p, training=self.training, mode=self.mode,
                         generator=self.generator, axis=self.axis)


class Dropout2D(Dropout):
    pass


def _fresh_generator(device) -> torch.Generator:
    """A generator on ``device`` seeded from the port's CPU generator."""
    seed = int(torch.randint(0, 2 ** 62, (1,),
                             generator=I.default_generator("cpu")))
    return torch.Generator(device=device).manual_seed(seed)


def reseed_dropouts(layer: torch.nn.Module) -> None:
    """Give each ``Dropout`` under ``layer`` a generator of its own on its
    generator's device, seeded from the port's generator: a deep copy
    clones its original's generator state, so copies would draw the
    same masks."""
    for m in layer.modules():
        if isinstance(m, Dropout):
            m.generator = _fresh_generator(m.generator.device)


def _act_layer(op_name, **fixed):
    op = getattr(K, op_name)

    class _Act(Layer):
        def __init__(self, name=None, **kw):
            super().__init__()
            self._kw = {**fixed, **kw}

        def forward(self, x):
            return op(x, **self._kw)

    _Act.__name__ = _Act.__qualname__ = op_name.title().replace("_", "")
    return _Act


ReLU = _act_layer("relu")
ReLU6 = _act_layer("relu6")
GELU = _act_layer("gelu")
SiLU = _act_layer("silu")
Swish = _act_layer("swish")
Mish = _act_layer("mish")
Sigmoid = _act_layer("sigmoid")
Tanh = _act_layer("tanh")
Softplus = _act_layer("softplus")
Softsign = _act_layer("softsign")
Hardswish = _act_layer("hardswish")
Hardsigmoid = _act_layer("hardsigmoid")
ELU = _act_layer("elu")
SELU = _act_layer("selu")
LogSigmoid = _act_layer("logsigmoid")
LogSoftmax = _act_layer("log_softmax")
Softmax = _act_layer("softmax")


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return K.leaky_relu(x, negative_slope=self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            (num_parameters,), default_initializer=I.Constant(init),
            attr=weight_attr)

    def forward(self, x):
        w = self.weight
        if x.dim() >= 2 and w.shape[0] > 1:
            w = w.reshape([1, w.shape[0]] + [1] * (x.dim() - 2))
        return K.prelu(x, w)


# -- pooling and resizing -----------------------------------------------------

class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode, self.data_format = ceil_mode, data_format

    def forward(self, x):
        return K.max_pool2d(x, self.kernel_size, stride=self.stride,
                            padding=self.padding, ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format="NCHW"):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.data_format = data_format

    def forward(self, x):
        return K.avg_pool2d(x, self.kernel_size, stride=self.stride,
                            padding=self.padding, ceil_mode=self.ceil_mode,
                            exclusive=self.exclusive,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return K.adaptive_avg_pool2d(x, self.output_size,
                                     data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return K.adaptive_max_pool2d(x, self.output_size,
                                     data_format=self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return K.flatten(x, start_axis=self.start_axis,
                         stop_axis=self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW"):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        h, w = (x.shape[2], x.shape[3]) if self.data_format == "NCHW" \
            else (x.shape[1], x.shape[2])
        if self.size is not None:
            oh, ow = self.size
        else:
            sf = self.scale_factor
            sf = (sf, sf) if isinstance(sf, (int, float)) else sf
            oh, ow = int(h * sf[0]), int(w * sf[1])
        if self.mode == "nearest":
            return K.interpolate_nearest(x, oh, ow,
                                         data_format=self.data_format)
        return K.interpolate_bilinear(x, oh, ow,
                                      align_corners=self.align_corners,
                                      data_format=self.data_format)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self.padding = [padding] * 4 if isinstance(padding, int) \
            else list(padding)
        self.mode, self.value, self.data_format = mode, value, data_format

    def forward(self, x):
        return K.pad(x, tuple(self.padding), mode=self.mode,
                     value=self.value, data_format=self.data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return K.pixel_shuffle(x, self.upscale_factor)


# -- containers ---------------------------------------------------------------

class Sequential(Layer):
    """``Sequential(l0, l1, ...)`` (named ``"0"``, ``"1"``, ...) or
    ``Sequential([(name, layer), ...])``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._modules.values())[idx]
        return self._modules[str(idx % len(self._modules))]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx % len(self._parameters))]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


__all__ = [
    "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "AvgPool2D", "BatchNorm1D",
    "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv2D", "Conv2DTranspose",
    "Dropout", "Dropout2D", "ELU", "Embedding", "Flatten", "GELU",
    "GroupNorm", "Hardsigmoid", "Hardswish", "Identity", "InstanceNorm2D",
    "LayerList", "LayerNorm", "LeakyReLU", "Linear", "LogSigmoid",
    "LogSoftmax", "MaxPool2D", "Mish", "PReLU", "Pad2D", "Parameter",
    "ParameterList", "PixelShuffle", "RMSNorm", "ReLU", "ReLU6", "SELU",
    "Sequential", "SiLU", "Sigmoid", "Softmax", "Softplus", "Softsign",
    "Swish", "Tanh", "Upsample"]
