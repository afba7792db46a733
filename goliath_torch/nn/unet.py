"""UNets of WN convs (port of the JAX package's nn/unet.py): ``UNetWB``
(untied biases, additive skips; the view-conditioned texture net of
mesh_vae), ``UNetWBConcat`` (untied biases, concatenated skips) and
``UNetW`` (tied biases, additive skips, any size). Five stride-2 4x4 convs
down and five transposed convs up, then a 1x1 conv over the last
activation concatenated with the input."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from goliath_torch.nn.layers import (
    Conv2dWN,
    Conv2dWNUB,
    ConvTranspose2dWN,
    ConvTranspose2dWNUB,
    leaky_relu,
)


def _downs(F: int, in_channels: int):
    return [(in_channels, F), (F, 2 * F), (2 * F, 4 * F), (4 * F, 8 * F),
            (8 * F, 16 * F)]


class UNetWB(nn.Module):
    """5-down/5-up UNet with additive skips, a final 1x1 conv over the
    concatenated input, output scaled by ``out_scale``."""

    def __init__(self, in_channels: int, out_channels: int, size: int,
                 n_init_ftrs: int = 8, out_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F, S, g = n_init_ftrs, size, generator
        self.out_scale = out_scale
        for i, (cin, cout) in enumerate(_downs(F, in_channels)):
            s = S // 2 ** (i + 1)
            self.add_module(f"down{i + 1}", Conv2dWNUB(cin, cout, s, s, 4, 2,
                                                       1, generator=g))
        ups = [(16 * F, 8 * F), (8 * F, 4 * F), (4 * F, 2 * F), (2 * F, F),
               (F, F)]
        for i, (cin, cout) in enumerate(ups):
            s = S // 2 ** (4 - i)
            self.add_module(f"up{i + 1}", ConvTranspose2dWNUB(
                cin, cout, s, s, 4, 2, 1, generator=g))
        self.out = Conv2dWNUB(F + in_channels, out_channels, S, S, 1,
                              alpha=1.0, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = [x]
        h = x
        for i in range(1, 6):
            h = leaky_relu(getattr(self, f"down{i}")(h), 0.2)
            skips.append(h)
        # skips: x1 (input), x2 .. x6; up1..up4 add x5..x2
        h = skips[5]
        for i in range(1, 5):
            h = leaky_relu(getattr(self, f"up{i}")(h), 0.2) + skips[5 - i]
        h = leaky_relu(self.up5(h), 0.2)
        h = torch.cat([h, x], dim=1)
        return self.out(h) * self.out_scale


class UNetWBConcat(nn.Module):
    """``UNetWB`` with each skip concatenated before the next transposed
    conv (no output scale)."""

    def __init__(self, in_channels: int, out_channels: int, size: int,
                 n_init_ftrs: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F, S, g = n_init_ftrs, size, generator
        for i, (cin, cout) in enumerate(_downs(F, in_channels)):
            s = S // 2 ** (i + 1)
            self.add_module(f"down{i + 1}", Conv2dWNUB(cin, cout, s, s, 4, 2,
                                                       1, generator=g))
        ups = [(16 * F, 8 * F), (16 * F, 4 * F), (8 * F, 2 * F), (4 * F, F),
               (2 * F, F)]
        for i, (cin, cout) in enumerate(ups):
            s = S // 2 ** (4 - i)
            self.add_module(f"up{i + 1}", ConvTranspose2dWNUB(
                cin, cout, s, s, 4, 2, 1, generator=g))
        self.out = Conv2dWNUB(F + in_channels, out_channels, S, S, 1,
                              alpha=1.0, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = [x]
        h = x
        for i in range(1, 6):
            h = leaky_relu(getattr(self, f"down{i}")(h), 0.2)
            skips.append(h)
        for i in range(1, 5):
            h = torch.cat([leaky_relu(getattr(self, f"up{i}")(h), 0.2),
                           skips[5 - i]], dim=1)
        h = leaky_relu(self.up5(h), 0.2)
        return self.out(torch.cat([h, x], dim=1))


class UNetW(nn.Module):
    """Tied-bias UNet with additive skips, for any input size divisible by
    32; output scaled by ``out_scale``."""

    def __init__(self, in_channels: int, out_channels: int, n_init_ftrs: int,
                 kernel_size: int = 4, out_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F, K, g = n_init_ftrs, kernel_size, generator
        self.out_scale = out_scale
        for i, (cin, cout) in enumerate(_downs(F, in_channels)):
            self.add_module(f"down{i + 1}", Conv2dWN(cin, cout, K, 2, 1,
                                                     generator=g))
        ups = [(16 * F, 8 * F), (8 * F, 4 * F), (4 * F, 2 * F), (2 * F, F),
               (F, F)]
        for i, (cin, cout) in enumerate(ups):
            self.add_module(f"up{i + 1}", ConvTranspose2dWN(
                cin, cout, K, 2, 1, generator=g))
        self.out = Conv2dWN(F + in_channels, out_channels, 1, alpha=1.0,
                            generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = [x]
        h = x
        for i in range(1, 6):
            h = leaky_relu(getattr(self, f"down{i}")(h), 0.2)
            skips.append(h)
        for i in range(1, 5):
            h = leaky_relu(getattr(self, f"up{i}")(h), 0.2) + skips[5 - i]
        h = leaky_relu(self.up5(h), 0.2)
        return self.out(torch.cat([h, x], dim=1)) * self.out_scale
