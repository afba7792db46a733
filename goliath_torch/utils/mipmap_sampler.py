"""Trilinear mipmap sampling (port of the JAX package's
utils/mipmap_sampler.py).

Samples every mip level with ``grid_sample``, then lerps between the floor
and ceil level of each sample by a continuous (roughness-driven) level.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from goliath_torch.utils.sampling import grid_sample


def mipmap_grid_sample(
    input: Union[Sequence[torch.Tensor], torch.Tensor],
    grid: torch.Tensor,
    mipmap_level: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "border",
    align_corners: bool = False,
) -> torch.Tensor:
    """input: mip levels [B, C, H_i, W_i]; grid: [B, Ho, Wo, 2];
    mipmap_level: [B, Ho, Wo] continuous level -> [B, C, Ho, Wo]."""
    if isinstance(input, torch.Tensor):
        input = [input]
    q = len(input)
    lam = mipmap_level.clamp(0.0, q - 1 - 1e-6)
    d1 = torch.floor(lam).to(torch.int64)
    a = lam - d1.to(lam.dtype)

    sampled = [grid_sample(level, grid, mode=mode, padding_mode=padding_mode,
                           align_corners=align_corners) for level in input]
    if q == 1:
        return sampled[0]
    stacked = torch.stack(sampled, dim=0)  # [q, B, C, Ho, Wo]
    idx = d1[None, :, None].expand((1,) + stacked.shape[1:])
    lo = torch.gather(stacked, 0, idx)[0]
    hi = torch.gather(stacked, 0, idx + 1)[0]
    return lo + (hi - lo) * a[:, None]
