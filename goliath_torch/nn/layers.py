"""Foundation layers (port of the JAX package's nn/layers.py): the
weight-normalized linear, conv and transposed conv with tied or untied
biases, the equalized-learning-rate linear and conv, the blur ``Downsample``,
``ConcatPyramid`` and the list-building factories.

Weight normalization is w = v * g / ||v||_F: ONE Frobenius norm over the
whole of v and a per-output-channel gain g (the JAX package's nn/layers.py:53-58,
the reference's WeightNorm with g_dim=out, v_dim=None). That is not
``torch.nn.utils.weight_norm``, which normalizes each output channel on its
own. "Untied bias" layers carry a (C, H, W) bias.

Parameters are named as in the JAX package (``weight_v``, ``weight_g``,
``bias``), so ``goliath_torch.convert.params_from_jax`` maps flax params
one to one. Transposed-conv weights are stored torch-style (in, out, kh,
kw) in both packages and carry over unchanged: JAX flips them to express
the op as a dilated conv, ``F.conv_transpose2d`` takes them as stored.

Init matches the reference glorot (uniform, gain sqrt(2 / (1 + alpha^2)),
transposed convs with ksize/4 fan and the checkerboard-avoiding 2x2
quadrant duplication; then g = ||v||_F), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def glorot_gain(alpha: float) -> float:
    return math.sqrt(2.0 / (1.0 + alpha**2))


def _uniform(shape, std: float, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
    bound = std * math.sqrt(3.0)
    return torch.rand(shape, generator=generator) * (2 * bound) - bound


def _wn_weight(v: torch.Tensor, g: torch.Tensor, g_axis: int) -> torch.Tensor:
    """w = v * g / ||v||_F, g broadcast along the output-channel axis."""
    norm = torch.sqrt(torch.sum(v**2))
    shape = [1] * v.dim()
    shape[g_axis] = -1
    return v * (g.reshape(shape) / norm.clamp(min=1e-12))


class _WNBase(nn.Module):
    g_axis = 0

    def _init_wn(self, v: torch.Tensor, bias_shape, use_bias: bool) -> None:
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(
            torch.full((v.shape[self.g_axis],), float(torch.sqrt((v**2).sum()))))
        self.bias = nn.Parameter(torch.zeros(bias_shape)) if use_bias else None

    def weight(self) -> torch.Tensor:
        return _wn_weight(self.weight_v, self.weight_g, self.g_axis)


class LinearWN(_WNBase):
    """Weight-normalized linear layer; weight stored (out, in)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, alpha: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = glorot_gain(alpha) * math.sqrt(2.0 / (in_features + out_features))
        self._init_wn(_uniform((out_features, in_features), std, generator),
                      (out_features,), use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight(), self.bias)


class Conv2dWN(_WNBase):
    """Weight-normalized conv, weight (out, in/groups, kh, kw), tied
    per-channel bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 use_bias: bool = True, alpha: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        std = glorot_gain(alpha) * math.sqrt(
            2.0 / ((in_channels + out_channels) * k * k))
        v = _uniform((out_channels, in_channels // groups, k, k), std,
                     generator)
        self._init_wn(v, (out_channels,), use_bias)
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight(), self.bias, self.stride,
                        self.padding, 1, self.groups)


class Conv2dWNUB(_WNBase):
    """Weight-normalized conv, weight (out, in/groups, kh, kw), untied
    (C, H, W) bias."""

    def __init__(self, in_channels: int, out_channels: int, height: int,
                 width: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, use_bias: bool = True,
                 alpha: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        std = glorot_gain(alpha) * math.sqrt(
            2.0 / ((in_channels + out_channels) * k * k))
        v = _uniform((out_channels, in_channels // groups, k, k), std,
                     generator)
        self._init_wn(v, (out_channels, height, width), use_bias)
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight(), None, self.stride, self.padding, 1,
                     self.groups)
        return y if self.bias is None else y + self.bias[None]


def _convt_init(shape, std: float, generator: Optional[torch.Generator]
                ) -> torch.Tensor:
    """Uniform init + 2x2 quadrant duplication (stride 2)."""
    w = _uniform(shape, std, generator)
    w[:, :, 0::2, 1::2] = w[:, :, 0::2, 0::2]
    w[:, :, 1::2, 0::2] = w[:, :, 0::2, 0::2]
    w[:, :, 1::2, 1::2] = w[:, :, 0::2, 0::2]
    return w


class ConvTranspose2dWN(_WNBase):
    """Weight-normalized transposed conv, weight (in, out, kh, kw) with g
    over out, tied per-channel bias."""

    g_axis = 1

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 alpha: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        std = glorot_gain(alpha) * math.sqrt(
            2.0 / ((in_channels + out_channels) * (k * k // 4)))
        v = _convt_init((in_channels, out_channels, k, k), std, generator)
        self._init_wn(v, (out_channels,), use_bias)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight(), self.bias, self.stride,
                                  self.padding)


class ConvTranspose2dWNUB(_WNBase):
    """Weight-normalized transposed conv, weight (in, out, kh, kw) with g
    over out, untied (C, H, W) bias."""

    g_axis = 1

    def __init__(self, in_channels: int, out_channels: int, height: int,
                 width: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, alpha: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        std = glorot_gain(alpha) * math.sqrt(
            2.0 / ((in_channels + out_channels) * (k * k // 4)))
        v = _convt_init((in_channels, out_channels, k, k), std, generator)
        self._init_wn(v, (out_channels, height, width), use_bias)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight(), None, self.stride,
                               self.padding)
        return y if self.bias is None else y + self.bias[None]


class UpConv2dWN(nn.Module):
    """Bilinear upsample by ``scale_factor`` (the JAX package's interpolation
    matrices), then a WN conv named ``conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, scale_factor: float = 2.0,
                 alpha: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = Conv2dWN(in_channels, out_channels, kernel_size, stride,
                             padding, alpha=alpha, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from goliath_torch.utils.sampling import interpolate_bilinear

        return self.conv(interpolate_bilinear(
            x, scale_factor=self.scale_factor))


def _register_list(module: nn.Module, attr: str, layers: Sequence[Any]
                   ) -> List[Any]:
    """Register the modules of ``layers`` under flax's names for a list
    attribute (``{attr}_{index}``, the index counting plain callables too)."""
    for i, layer in enumerate(layers):
        if isinstance(layer, nn.Module):
            module.add_module(f"{attr}_{i}", layer)
    return list(layers)


class Sequential(nn.Module):
    """Applies a list of modules and plain callables in order."""

    def __init__(self, layers: Sequence[Any]):
        super().__init__()
        self.layers = _register_list(self, "layers", layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class LeakyReLU:
    """Leaky-ReLU activation as a plain callable, equal to another of the
    same slope."""

    def __init__(self, slope: float = 0.2):
        self.slope = slope

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.slope)

    def __hash__(self):
        return hash(("LeakyReLU", self.slope))

    def __eq__(self, other):
        return isinstance(other, LeakyReLU) and other.slope == self.slope


def make_linear(n_in: int, n_out: int, mode: str = "wn", act=None,
                bias: bool = True,
                generator: Optional[torch.Generator] = None) -> List[Any]:
    assert mode == "wn"
    layers: List[Any] = [LinearWN(n_in, n_out, use_bias=bias,
                                  generator=generator)]
    if act is not None:
        layers.append(act)
    return layers


def make_conv(n_in, n_out, fs, stride, pad, mode="wn", act=None, trans=False,
              ub=None, bias=True,
              generator: Optional[torch.Generator] = None) -> List[Any]:
    assert mode == "wn"
    if ub:
        cls = ConvTranspose2dWNUB if trans else Conv2dWNUB
        layer = cls(n_in, n_out, ub[0], ub[1], fs, stride, pad,
                    use_bias=bias, generator=generator)
    else:
        cls = ConvTranspose2dWN if trans else Conv2dWN
        layer = cls(n_in, n_out, fs, stride, pad, use_bias=bias,
                    generator=generator)
    layers: List[Any] = [layer]
    if act is not None:
        layers.append(act)
    return layers


def make_conv_trans(*args, **kwargs) -> List[Any]:
    return make_conv(*args, **kwargs, trans=True)


def gaussian_kernel(ksize: int, std: Optional[float] = None) -> np.ndarray:
    """2D gaussian kernel, normalized to sum 1."""
    assert ksize % 2 == 1
    radius = ksize // 2
    if std is None:
        std = np.sqrt(-(radius**2) / (2 * np.log(0.05)))
    x, y = np.meshgrid(
        np.linspace(-radius, radius, ksize), np.linspace(-radius, radius, ksize)
    )
    gk = np.exp(-(x**2 + y**2) / (2 * std**2))
    return (gk / gk.sum()).astype(np.float32)


def _depthwise_kernel(gk: np.ndarray, channels: int) -> torch.Tensor:
    return torch.from_numpy(np.tile(gk[None, None], (channels, 1, 1, 1)))


class ConcatPyramid(nn.Module):
    """Wraps a conv branch taking one input X into a branch taking (X, Y):
    before each conv layer, a level of a gaussian blur-and-decimate pyramid
    of Y is concatenated. The pyramid is consumed coarse-to-fine.

    every_other: the branch alternates conv and nonlinearity.
    transposed: the branch upsamples; the pyramid starts one
    blur-decimation below Y."""

    def __init__(self, branch: Sequence[Any], n_concat_in: int,
                 every_other: bool = True, ksize: int = 7,
                 kstd: Optional[float] = None, transposed: bool = False):
        super().__init__()
        self.branch = _register_list(self, "branch", branch)
        self.every_other, self.transposed = every_other, transposed
        self.pad = ksize // 2
        self.register_buffer("blur", _depthwise_kernel(
            gaussian_kernel(ksize, kstd), n_concat_in), persistent=False)

    def _blur_decimate(self, img: torch.Tensor) -> torch.Tensor:
        blurred = F.conv2d(img, self.blur, padding=self.pad,
                           groups=self.blur.shape[0])
        return blurred[:, :, ::2, ::2]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        levels = ((len(self.branch) + 1) // 2 if self.every_other
                  else len(self.branch))
        pyramid = [self._blur_decimate(y) if self.transposed else y]
        for _ in range(levels - 1):
            pyramid.insert(0, self._blur_decimate(pyramid[0]))
        out = x
        for i, layer in enumerate(self.branch):
            if (i % 2) == 0 or not self.every_other:
                idx = i // 2 if self.every_other else i
                out = torch.cat([out, pyramid[idx]], dim=1)
            out = layer(out)
        return out


class LinearELR(nn.Module):
    """Equalized-learning-rate linear: ``weight`` (out, in) stored
    N(0, 1/lr_mul), scaled at run time by gain/sqrt(fan_in)*lr_mul; the bias
    by lr_mul."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, gain: Optional[float] = None,
                 lr_mul: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gain = math.sqrt(2.0) if gain is None else gain
        self.std = gain / math.sqrt(in_features) * lr_mul
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(torch.randn(
            (out_features, in_features), generator=generator) / lr_mul)
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ (self.weight * self.std).T
        return y if self.bias is None else y + self.bias * self.lr_mul


class Conv2dELR(nn.Module):
    """Equalized-learning-rate conv, ``weight`` (out, in, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 gain: Optional[float] = None, lr_mul: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gain = math.sqrt(2.0) if gain is None else gain
        fan_in = in_channels * kernel_size**2
        self.std = gain / math.sqrt(fan_in) * lr_mul
        self.lr_mul, self.stride, self.padding = lr_mul, stride, padding
        self.weight = nn.Parameter(torch.randn(
            (out_channels, in_channels, kernel_size, kernel_size),
            generator=generator) / lr_mul)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight * self.std, None, self.stride,
                     self.padding)
        if self.bias is None:
            return y
        return y + (self.bias * self.lr_mul)[None, :, None, None]


class Downsample(nn.Module):
    """Antialiased 2x downsample: a depthwise gaussian blur (``ksize``)
    with stride 2."""

    def __init__(self, ksize: int = 5):
        super().__init__()
        self.pad = ksize // 2
        self.gk = gaussian_kernel(ksize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[1]
        w = _depthwise_kernel(self.gk, C).to(device=x.device, dtype=x.dtype)
        return F.conv2d(x, w, None, 2, self.pad, 1, C)
