"""Shadow networks (port of the JAX package's nn/shadow.py).

``ShadowUNet``: AO map -> soft shadow map through a small UNet over the
``shadow_size`` grid, sigmoid(beta + x), bilinearly upsampled to
``uv_size``. The stored AO mean is nearest-resized to the grid once, on the
host. ``ShadowUNet_PoseCond``: the same UNet with a tiled, conv-encoded pose
concatenated at the bottleneck. ``DistMapShadowUNet``: the same UNet over
per-joint distance maps (no mean). ``FloorShadowDecoder``: a fixed
512-resolution UNet with additive skips. ``PoseToShadow``: the distilled
pose -> shadow conv-transpose stack. Each resize keeps the JAX call's
``align_corners``: False into the grid and out to ``uv_size``, True inside
the UNet and for the floor decoder's AO map.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from goliath_torch.nn.blocks import tile2d
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


class _GridUNet(nn.Module):
    """The UNet the three grid shadow nets share: encoders ``enc0``-``enc3``
    at S, S/2, S/4, S/8 (bilinear halving between them), decoders
    ``dec0``-``dec3`` back up with each encoder's activation concatenated,
    and ``shadow_pred``; sigmoid(pred + beta) at S and at ``uv_size``."""

    def _build_unet(self, uv_size: int, shadow_size: int, n_in: int,
                    n_dims: int, n_bottleneck: int, lrelu_slope: float,
                    beta: float, biases: bool,
                    generator: Optional[torch.Generator]) -> None:
        S, n, g = shadow_size, n_dims, generator
        self.uv_size, self.shadow_size = uv_size, shadow_size
        self.lrelu_slope, self.beta = lrelu_slope, beta
        self.sizes = [S // 2**i for i in range(4)]
        for i, (cin, cout) in enumerate([(n_in, n), (n, n), (n, n), (n, n)]):
            s = self.sizes[i]
            self.add_module(f"enc{i}", Conv2dWNUB(cin, cout, s, s, 3, 1, 1,
                                                  generator=g))
        for i, (cin, cout) in enumerate([(n + n_bottleneck, n), (2 * n, n),
                                         (2 * n, n), (2 * n, n)]):
            s = self.sizes[-i - 1]
            self.add_module(f"dec{i}", Conv2dWNUB(cin, cout, s, s, 3, 1, 1,
                                                  generator=g))
        if biases:
            self.shadow_pred = Conv2dWNUB(n, 1, S, S, 3, 1, 1, alpha=1.0,
                                          generator=g)
        else:
            self.shadow_pred = Conv2dWN(n, 1, 3, 1, 1, alpha=1.0, generator=g)

    def _encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        enc_acts = []
        for i, size in enumerate(self.sizes):
            x = leaky_relu(getattr(self, f"enc{i}")(x), self.lrelu_slope)
            enc_acts.append(x)
            if i < len(self.sizes) - 1:
                x = interpolate_bilinear(x, size=(size // 2, size // 2),
                                         align_corners=True)
        return enc_acts

    def _decode(self, x: torch.Tensor, enc_acts: List[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
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
        return {"shadow_map": shadow_map,
                "shadow_map_lowres": shadow_map_lowres}

    def _to_grid(self, x: torch.Tensor) -> torch.Tensor:
        S = self.shadow_size
        return x if x.shape[-2:] == (S, S) else interpolate_bilinear(
            x, size=(S, S))


class ShadowUNet(_GridUNet):
    def __init__(self, uv_size: int, ao_mean: Any, shadow_size: int,
                 lrelu_slope: float = 0.2, beta: float = 1.0,
                 n_dims: int = 64, interp_mode: str = "bilinear",
                 biases: bool = True, trainable_mean: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del interp_mode  # bilinear only, as in the JAX package
        S = shadow_size
        mean = np.asarray(ao_mean, np.float32)
        if mean.shape[-2:] != (S, S):
            mean = nearest_resize_np(mean, S)
        mean = torch.from_numpy(np.ascontiguousarray(mean))
        if trainable_mean:
            self.ao_mean = nn.Parameter(mean)
        else:
            self.register_buffer("ao_mean", mean, persistent=False)
        self._build_unet(uv_size, S, 1, n_dims, 0, lrelu_slope, beta, biases,
                         generator)

    def forward(self, ao_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        ao_map = self._to_grid(ao_map)
        enc_acts = self._encode(ao_map - self.ao_mean)
        out = self._decode(enc_acts[-1], enc_acts)
        return {"shadow_map": out["shadow_map"], "ao_map": ao_map,
                "shadow_map_lowres": out["shadow_map_lowres"]}


class ShadowUNet_PoseCond(_GridUNet):
    """``ShadowUNet`` with the pose vector tiled over the bottleneck
    (``tile2d``), encoded by ``pose_conv_block`` and concatenated before the
    decoders. The AO mean is subtracted before the resize to the grid and
    is not resized. The reference's unused ``pose_fc_block`` is left out,
    as in the JAX package."""

    def __init__(self, uv_size: int, ao_mean: Any, shadow_size: int,
                 lrelu_slope: float = 0.2, beta: float = 1.0,
                 n_dims: int = 64, n_pose_dims: int = 6,
                 n_pose_enc_dims: int = 32, interp_mode: str = "bilinear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del interp_mode
        self.register_buffer("ao_mean", torch.from_numpy(np.ascontiguousarray(
            np.asarray(ao_mean, np.float32))), persistent=False)
        self._build_unet(uv_size, shadow_size, 1, n_dims, n_pose_enc_dims,
                         lrelu_slope, beta, True, generator)
        b = self.sizes[-1]
        self.pose_conv_block = Conv2dWNUB(n_pose_dims, n_pose_enc_dims, b, b,
                                          3, 1, 1, generator=generator)

    def forward(self, ao_map: torch.Tensor, pose_vec: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        enc_acts = self._encode(self._to_grid(ao_map - self.ao_mean))
        pose_enc = self.pose_conv_block(tile2d(pose_vec, self.sizes[-1]))
        out = self._decode(torch.cat([enc_acts[-1], pose_enc], dim=1),
                           enc_acts)
        return {"shadow_map": out["shadow_map"], "ao_map": ao_map}


class DistMapShadowUNet(_GridUNet):
    """``ShadowUNet`` over ``n_dist_joints`` per-joint distance maps, no
    mean subtracted; ``biases`` switches the last conv between untied and
    tied bias."""

    def __init__(self, uv_size: int, shadow_size: int, n_dist_joints: int,
                 lrelu_slope: float = 0.2, beta: float = 1.0,
                 n_dims: int = 64, interp_mode: str = "bilinear",
                 biases: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del interp_mode
        self._build_unet(uv_size, shadow_size, n_dist_joints, n_dims, 0,
                         lrelu_slope, beta, biases, generator)

    def forward(self, dist_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        enc_acts = self._encode(self._to_grid(dist_map))
        return self._decode(enc_acts[-1], enc_acts)


class FloorShadowDecoder(nn.Module):
    """AO map -> floor shadow through a fixed 512-resolution UNet with
    additive skips: (tanh(up5(x) + aomap) + 1) / 2, the AO map resized to
    ``uv_size`` (align_corners=True) where it is not. ``beta`` is kept for
    the configs and unused, as in the JAX package."""

    DOWN = [(1, 64, 256), (64, 64, 128), (64, 128, 64), (128, 256, 32),
            (256, 512, 16)]
    UP = [(512, 256, 32), (256, 128, 64), (128, 64, 128), (64, 64, 256)]

    def __init__(self, uv_size: int, beta: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.uv_size, self.beta = uv_size, beta
        for i, (cin, cout, size) in enumerate(self.DOWN):
            self.add_module(f"down{i + 1}", Conv2dWNUB(
                cin, cout, size, size, 4, 2, 1, generator=g))
        for i, (cin, cout, size) in enumerate(self.UP):
            self.add_module(f"up{i + 1}", ConvTranspose2dWNUB(
                cin, cout, size, size, 4, 2, 1, generator=g))
        self.up5 = ConvTranspose2dWNUB(64, 1, 512, 512, 4, 2, 1, alpha=1.0,
                                       generator=g)

    def forward(self, aomap: torch.Tensor) -> Dict[str, torch.Tensor]:
        if aomap.shape[-2:] != (self.uv_size, self.uv_size):
            aomap = interpolate_bilinear(
                aomap, size=(self.uv_size, self.uv_size), align_corners=True)
        x = aomap - 0.5
        skips = []
        for i in range(len(self.DOWN)):
            x = leaky_relu(getattr(self, f"down{i + 1}")(x), 0.2)
            skips.append(x)
        for i in range(len(self.UP)):
            x = leaky_relu(getattr(self, f"up{i + 1}")(x), 0.2) + skips[-i - 2]
        x = self.up5(x)
        return {"shadow_map": (torch.tanh(x + aomap) + 1.0) / 2.0}


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
