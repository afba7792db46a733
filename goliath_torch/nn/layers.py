"""Weight-normalized layers with untied biases (port of
the JAX package's nn/layers.py, the layers RGCA and mesh_vae use).

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
from typing import Optional

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
