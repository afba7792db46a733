"""Shadow networks (port of the JAX package's nn/shadow.py, the two that
mesh_vae builds).

``ShadowUNet``: AO map -> soft shadow map through a small UNet over the
``shadow_size`` grid, sigmoid(beta + x), bilinearly upsampled to
``uv_size``. The stored AO mean is nearest-resized to the grid once, on the
host. ``PoseToShadow``: the distilled pose -> shadow conv-transpose stack.
The floor, pose-conditioned and distance-map variants come with the paths
that use them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from goliath_torch.nn.layers import (
    Conv2dWN,
    Conv2dWNUB,
    ConvTranspose2dWNUB,
    LinearWN,
    leaky_relu,
)
from goliath_torch.utils.sampling import interpolate_bilinear


def nearest_resize_np(x: np.ndarray, size: int) -> np.ndarray:
    """[..., H, W] -> [..., size, size] by taking rows and columns
    floor(i * H / size) (the JAX package's host-side resize of the AO
    mean)."""
    ys = (np.arange(size) * x.shape[-2] / size).astype(np.int64)
    xs = (np.arange(size) * x.shape[-1] / size).astype(np.int64)
    return x[..., ys, :][..., xs]


class ShadowUNet(nn.Module):
    def __init__(self, uv_size: int, ao_mean: Any, shadow_size: int,
                 lrelu_slope: float = 0.2, beta: float = 1.0,
                 n_dims: int = 64, interp_mode: str = "bilinear",
                 biases: bool = True, trainable_mean: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del interp_mode  # bilinear only, as in the JAX package
        S, n, g = shadow_size, n_dims, generator
        self.uv_size, self.shadow_size = uv_size, shadow_size
        self.lrelu_slope, self.beta = lrelu_slope, beta
        mean = np.asarray(ao_mean, np.float32)
        if mean.shape[-2:] != (S, S):
            mean = nearest_resize_np(mean, S)
        mean = torch.from_numpy(np.ascontiguousarray(mean))
        if trainable_mean:
            self.ao_mean = nn.Parameter(mean)
        else:
            self.register_buffer("ao_mean", mean, persistent=False)
        self.sizes = [S // 2**i for i in range(4)]
        for i, (cin, cout) in enumerate([(1, n), (n, n), (n, n), (n, n)]):
            s = self.sizes[i]
            self.add_module(f"enc{i}", Conv2dWNUB(cin, cout, s, s, 3, 1, 1,
                                                  generator=g))
        for i, (cin, cout) in enumerate([(n, n), (2 * n, n), (2 * n, n),
                                         (2 * n, n)]):
            s = self.sizes[-i - 1]
            self.add_module(f"dec{i}", Conv2dWNUB(cin, cout, s, s, 3, 1, 1,
                                                  generator=g))
        if biases:
            self.shadow_pred = Conv2dWNUB(n, 1, S, S, 3, 1, 1, alpha=1.0,
                                          generator=g)
        else:
            self.shadow_pred = Conv2dWN(n, 1, 3, 1, 1, alpha=1.0, generator=g)

    def forward(self, ao_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        S = self.shadow_size
        if ao_map.shape[-2:] != (S, S):
            ao_map = interpolate_bilinear(ao_map, size=(S, S))
        x = ao_map - self.ao_mean
        enc_acts = []
        for i, size in enumerate(self.sizes):
            x = leaky_relu(getattr(self, f"enc{i}")(x), self.lrelu_slope)
            enc_acts.append(x)
            if i < len(self.sizes) - 1:
                x = interpolate_bilinear(x, size=(size // 2, size // 2),
                                         align_corners=True)
        for i in range(len(self.sizes)):
            if i > 0:
                x_prev = enc_acts[-i - 1]
                x = interpolate_bilinear(x, size=tuple(x_prev.shape[2:4]),
                                         align_corners=True)
                x = torch.cat([x, x_prev], dim=1)
            x = leaky_relu(getattr(self, f"dec{i}")(x), self.lrelu_slope)
        shadow_map_lowres = torch.sigmoid(self.shadow_pred(x) + self.beta)
        shadow_map = interpolate_bilinear(shadow_map_lowres,
                                          size=(self.uv_size, self.uv_size))
        return {"shadow_map": shadow_map, "ao_map": ao_map,
                "shadow_map_lowres": shadow_map_lowres}


class PoseToShadow(nn.Module):
    def __init__(self, n_pose_dims: int, uv_size: int, beta: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.uv_size, self.beta = uv_size, beta
        self.fc = LinearWN(n_pose_dims, 256 * 4 * 4, generator=g)
        chans = [(256, 256, 8), (256, 128, 16), (128, 128, 32), (128, 64, 64)]
        for i, (cin, cout, size) in enumerate(chans):
            self.add_module(f"conv{i}", ConvTranspose2dWNUB(
                cin, cout, size, size, 4, 2, 1, generator=g))
        self.out = ConvTranspose2dWNUB(64, 1, 128, 128, 4, 2, 1, alpha=1.0,
                                       generator=g)

    def forward(self, pose: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = leaky_relu(self.fc(pose), 0.2).reshape(-1, 256, 4, 4)
        for i in range(4):
            x = leaky_relu(getattr(self, f"conv{i}")(x), 0.2)
        shadow_map_lowres = torch.sigmoid(self.out(x) + self.beta)
        return {"shadow_map": interpolate_bilinear(
            shadow_map_lowres, size=(self.uv_size, self.uv_size))}
