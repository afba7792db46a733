"""Residual conv blocks (port of the JAX package's nn/blocks.py).

ConvBlock / ConvDownBlock / UpConvBlockDeep: two 3x3 untied-bias WN convs
with a 1x1 WN skip; the up block bilinearly upsamples first (the JAX
package's interpolation matrices, ``utils/sampling.interpolate_bilinear``).
Submodules carry the flax names (``conv_resize``, ``conv1``, ``conv2``).
``PixelShuffleWN`` is a WN 1x1 conv with ICNR init before a pixel shuffle;
the blocks' ``UpscaleNet`` is a small super-resolution head on it (distinct
from mesh_vae's own ``UpscaleNet`` in ``models/mesh_vae.py``, as in the JAX
package).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from goliath_torch.nn.layers import Conv2dWN, Conv2dWNUB, _WNBase, leaky_relu
from goliath_torch.utils.sampling import interpolate_bilinear


def tile1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, C] -> [B, C, size]."""
    return x[:, :, None].expand(x.shape + (size,))


def tile2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, C] -> [B, C, size, size]."""
    return x[:, :, None, None].expand(x.shape + (size, size))


class ConvBlock(nn.Module):
    """conv-lrelu-conv-lrelu + 1x1 skip."""

    def __init__(self, in_channels: int, out_channels: int, size: int,
                 lrelu_slope: float = 0.2, kernel_size: int = 3,
                 padding: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.lrelu_slope = lrelu_slope
        self.conv_resize = Conv2dWN(in_channels, out_channels, 1, generator=g)
        self.conv1 = Conv2dWNUB(in_channels, in_channels, size, size,
                                kernel_size, 1, padding, generator=g)
        self.conv2 = Conv2dWNUB(in_channels, out_channels, size, size,
                                kernel_size, 1, padding, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_skip = self.conv_resize(x)
        h = leaky_relu(self.conv1(x), self.lrelu_slope)
        h = leaky_relu(self.conv2(h), self.lrelu_slope)
        return h + x_skip


class ConvDownBlock(nn.Module):
    """Residual stride-2 down block; ``size`` is the input size."""

    def __init__(self, in_channels: int, out_channels: int, size: int,
                 lrelu_slope: float = 0.2, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.lrelu_slope = lrelu_slope
        self.conv_resize = Conv2dWN(in_channels, out_channels, 1, 2, 0,
                                    groups=groups, generator=g)
        self.conv1 = Conv2dWNUB(in_channels, in_channels, size, size, 3, 1, 1,
                                groups=groups, generator=g)
        self.conv2 = Conv2dWNUB(in_channels, out_channels, size // 2,
                                size // 2, 3, 2, 1, groups=groups, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_skip = self.conv_resize(x)
        h = leaky_relu(self.conv1(x), self.lrelu_slope)
        h = leaky_relu(self.conv2(h), self.lrelu_slope)
        return h + x_skip


class UpConvBlockDeep(nn.Module):
    """Bilinear up (align_corners=True) + residual double conv; ``size`` is
    the output size."""

    def __init__(self, in_channels: int, out_channels: int, size: int,
                 lrelu_slope: float = 0.2, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.size = size
        self.lrelu_slope = lrelu_slope
        self.conv_resize = Conv2dWN(in_channels, out_channels, 1,
                                    groups=groups, generator=g)
        self.conv1 = Conv2dWNUB(in_channels, in_channels, size, size, 3, 1, 1,
                                groups=groups, generator=g)
        self.conv2 = Conv2dWNUB(in_channels, out_channels, size, size, 3, 1, 1,
                                groups=groups, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_up = interpolate_bilinear(x, size=(self.size, self.size),
                                    align_corners=True)
        x_skip = self.conv_resize(x_up)
        h = leaky_relu(self.conv1(x_up), self.lrelu_slope)
        h = leaky_relu(self.conv2(h), self.lrelu_slope)
        return h + x_skip


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """[B, C*r^2, H, W] -> [B, C, H*r, W*r] (torch PixelShuffle semantics)."""
    B, C, H, W = x.shape
    r = upscale
    Co = C // (r * r)
    x = x.reshape(B, Co, r, r, H, W).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, Co, H * r, W * r)


def _icnr_uniform(shape, scale: int = 2,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """ICNR init for pixel-shuffle convs: one sub-kernel drawn
    U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) and each of its output channels
    repeated scale^2 times in a row."""
    out, in_c, kh, kw = shape
    bound = math.sqrt(6.0 / (in_c * kh * kw))
    sub = torch.rand((out // scale**2, in_c, kh, kw),
                     generator=generator) * (2 * bound) - bound
    return torch.repeat_interleave(sub, scale**2, dim=0)


class PixelShuffleWN(_WNBase):
    """WN 1x1 conv (ICNR init, tied bias) + pixel shuffle."""

    def __init__(self, in_channels: int, out_channels: int,
                 upscale_factor: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        oc = out_channels * upscale_factor**2
        self._init_wn(_icnr_uniform((oc, in_channels, 1, 1), upscale_factor,
                                    generator), (oc,), True)
        self.upscale_factor = upscale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(F.conv2d(x, self.weight(), self.bias),
                             self.upscale_factor)


class UpscaleNet(nn.Module):
    """Small pixel-shuffle super-resolution head: two untied-bias 3x3 WN
    convs, then ``PixelShuffleWN``."""

    def __init__(self, in_channels: int, out_channels: int = 3,
                 n_ftrs: int = 16, size: int = 1024, upscale_factor: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv_block1 = Conv2dWNUB(in_channels, n_ftrs, size, size, 3, 1,
                                      1, generator=g)
        self.conv_block2 = Conv2dWNUB(n_ftrs, n_ftrs, size, size, 3, 1, 1,
                                      generator=g)
        self.out_block = PixelShuffleWN(n_ftrs, out_channels, upscale_factor,
                                        generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.conv_block1(x), 0.2)
        h = leaky_relu(self.conv_block2(h), 0.2)
        return self.out_block(h)
