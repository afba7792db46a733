"""Image sampling by gather and lerp (port of the JAX package's utils/sampling.py,
the parts the RGCA and mesh_vae paths use).

``grid_sample`` follows torch's convention and the JAX package's formula
term for term (four gathers, zero or border padding), so both packages give
the same numbers. ``interpolate_bilinear`` builds the JAX package's
separable two-tap interpolation matrices (in float64, then float32) and
applies them as matrix products, so its weights are those of the JAX
package to the bit; ``F.interpolate`` computes its weights in float32 from
a float32 scale, which differs in the last bits wherever the ratio of the
sizes is not a power of two (the pixel bias of mesh_vae, 166 -> 1334).
``grid_sample_3d`` and ``avg_pool2d`` come with the paths that use them
(ROADMAP queue 1).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Literal

import numpy as np
import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool
                 ) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gather2d(image: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor
              ) -> torch.Tensor:
    """image [B, C, H, W], iy/ix [B, ...spatial] -> [B, C, ...spatial]."""
    B, C, H, W = image.shape
    flat = image.reshape(B, C, H * W)
    idx = (iy * W + ix).reshape(B, 1, -1).expand(B, C, -1)
    return torch.gather(flat, 2, idx.long()).reshape((B, C) + iy.shape[1:])


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    mode: Literal["bilinear", "nearest"] = "bilinear",
    padding_mode: Literal["zeros", "border"] = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Sample ``image`` [B, C, H, W] at ``grid`` [B, Ho, Wo, 2] -> [B, C, Ho, Wo].

    grid[..., 0] is x (width), grid[..., 1] is y (height), in [-1, 1].
    """
    B, C, H, W = image.shape
    x = _unnormalize(grid[..., 0], W, align_corners)
    y = _unnormalize(grid[..., 1], H, align_corners)

    if mode == "nearest":
        # round half to even, as jnp.round does
        ix = torch.round(x).to(torch.int64)
        iy = torch.round(y).to(torch.int64)
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        out = _gather2d(image, iy.clamp(0, H - 1), ix.clamp(0, W - 1))
        if padding_mode == "zeros":
            out = out * valid[:, None].to(image.dtype)
        return out

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(image.dtype)
    wy = (y - y0).to(image.dtype)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    out = image.new_zeros((B, C) + tuple(grid.shape[1:-1]))
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0i + dx
            yi = y0i + dy
            w = (wx if dx else (1.0 - wx)) * (wy if dy else (1.0 - wy))
            if padding_mode == "zeros":
                valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                w = w * valid.to(image.dtype)
            out = out + _gather2d(image, yi.clamp(0, H - 1),
                                  xi.clamp(0, W - 1)) * w[:, None]
    return out


@lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Static 1-D bilinear interpolation matrix [n_out, n_in] (2 taps/row),
    the JAX package's ``_interp_matrix``, on ``device``. Built once per
    (sizes, device, dtype): a frame would otherwise copy it to the card at
    every call."""
    if align_corners:
        xs = np.linspace(0.0, n_in - 1.0, n_out, dtype=np.float64)
    else:
        xs = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.clip(np.floor(xs), 0, n_in - 1)
    x1 = np.clip(x0 + 1, 0, n_in - 1)
    w = np.clip(xs - x0, 0.0, 1.0)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    m[rows, x0.astype(np.int64)] += (1.0 - w).astype(np.float32)
    m[rows, x1.astype(np.int64)] += w.astype(np.float32)
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def interpolate_bilinear(image: torch.Tensor,
                         scale_factor: float | None = None,
                         size: tuple[int, int] | None = None,
                         align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate(mode='bilinear')`` for [B, C, H, W] as the separable
    matrix products out = My @ img @ Mx^T of the JAX package."""
    B, C, H, W = image.shape
    if size is None:
        size = (int(H * scale_factor), int(W * scale_factor))
    Ho, Wo = size
    out = image
    if Ho != H:
        my = _interp_matrix(H, Ho, align_corners, image.device, image.dtype)
        out = torch.einsum("oh,bchw->bcow", my, out)
    if Wo != W:
        mx = _interp_matrix(W, Wo, align_corners, image.device, image.dtype)
        out = torch.einsum("pw,bchw->bchp", mx, out)
    return out
