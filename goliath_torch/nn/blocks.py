"""Residual conv blocks (port of the JAX package's nn/blocks.py, the blocks
mesh_vae uses).

ConvBlock / ConvDownBlock / UpConvBlockDeep: two 3x3 untied-bias WN convs
with a 1x1 WN skip; the up block bilinearly upsamples first (the JAX
package's interpolation matrices, ``utils/sampling.interpolate_bilinear``).
Submodules carry the flax names (``conv_resize``, ``conv1``, ``conv2``).
``PixelShuffleWN`` and the blocks' ``UpscaleNet`` come with the paths that
use them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from goliath_torch.nn.layers import Conv2dWN, Conv2dWNUB, leaky_relu
from goliath_torch.utils.sampling import interpolate_bilinear


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
