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
``grid_sample_3d`` (the OLAT teacher's deep shadows) takes the JAX
package's eight gathers term for term too. ``avg_pool2d`` (the envmap's
mip pyramid) and ``linspace`` (``jnp.linspace``'s float32 bits) serve the
envmap branch and the OLAT teacher.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Literal, Optional

import numpy as np
import torch


def sat_int(x: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """Float -> int as XLA converts: saturating, NaN to 0 (a plain
    ``.to(int)`` gives INT_MIN for inf and NaN on the CPU)."""
    return torch.nan_to_num(x, nan=0.0).clamp(
        -2.0 ** 31, 2.0 ** 31 - 128).to(dtype)


def linspace(start: float, stop: float, n: int,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, n)`` to the bit (``torch.
    linspace`` differs in the last bit at n >= 4). XLA computes
    start * (1 - i * r) + i * (stop * r) with r = 1 / (n - 1) rounded to
    float32 and the last add fused into a multiply-add; the product of two
    float32 values is exact in float64, so the fused add is one float64 add
    rounded to float32 (held against ``jnp.linspace`` in the tests)."""
    if n == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    r = torch.tensor(1.0 / (n - 1), dtype=torch.float32)
    i = torch.arange(n - 1, dtype=torch.float32)
    head = start * (1.0 - i * r)
    head = (i.double() * (stop * r).double() + head.double()).float()
    return torch.cat([head, torch.tensor([stop])]).to(device)


def avg_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Average pool [B, C, H, W] with stride == kernel == k."""
    B, C, H, W = x.shape
    return x.reshape(B, C, H // k, k, W // k, k).mean(dim=(3, 5))


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


def _axis_taps(coord: torch.Tensor, size: int, align_corners: bool,
               zero_pad: bool, dtype: torch.dtype):
    """The two taps of trilinear sampling along one axis: clamped int64
    indices (i0, i1) and weights (1 - w, w), each weight multiplied by its
    tap's in-range mask under zero padding. The JAX package multiplies a
    corner's weight product by the corner's mask; a product with 1 is
    exact and with 0 is 0, so taking the masks per axis gives its values."""
    c = _unnormalize(coord, size, align_corners)
    c0 = torch.floor(c)
    w = (c - c0).to(dtype)
    i0 = sat_int(c0)
    i1 = i0 + 1
    w0, w1 = 1 - w, w
    if zero_pad:
        w0 = w0 * ((i0 >= 0) & (i0 < size)).to(dtype)
        w1 = w1 * ((i1 >= 0) & (i1 < size)).to(dtype)
    return (i0.clamp(0, size - 1), i1.clamp(0, size - 1)), (w0, w1)


def grid_sample_3d(
    vol: torch.Tensor,
    coords: torch.Tensor,
    padding_mode: Literal["zeros", "border"] = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Trilinear samples of ``vol`` [C, D, H, W] at ``coords`` [..., 3]
    ((x, y, z) in [-1, 1]) -> [C, ...], the JAX package's
    ``grid_sample_3d``: corner weights (x, y, z) multiplied in that order,
    corners summed z-major; "border" clamps the corner indices."""
    C, D, H, W = vol.shape
    zero_pad = padding_mode == "zeros"
    (x0, x1), (wx0, wx1) = _axis_taps(coords[..., 0], W, align_corners,
                                      zero_pad, vol.dtype)
    (y0, y1), (wy0, wy1) = _axis_taps(coords[..., 1], H, align_corners,
                                      zero_pad, vol.dtype)
    (z0, z1), (wz0, wz1) = _axis_taps(coords[..., 2], D, align_corners,
                                      zero_pad, vol.dtype)
    flat = vol.reshape(C, -1)
    out = None
    for zi, wz in ((z0, wz0), (z1, wz1)):
        for yi, wy in ((y0, wy0), (y1, wy1)):
            zy = (zi * H + yi) * W
            for xi, wx in ((x0, wx0), (x1, wx1)):
                term = flat[:, zy + xi] * (wx * wy * wz)
                out = term if out is None else out + term
    return out
