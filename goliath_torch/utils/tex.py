"""UV unprojection of a camera image (port of the JAX package's
utils/tex.py; reference: ca_code/utils/tex.py:21-63).

One ``rasterize`` per view through ``ops/rasterizer.py``: on the card, two
K4 scans in its binning and one K5 z-buffer launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from goliath_torch.ops.rasterizer import RenderLayer, rasterize, transform
from goliath_torch.utils.geom import compute_view_texture


def get_tex_rl(
    rl: RenderLayer,
    image: torch.Tensor,        # [B, 3, H, W]
    ply: Tuple[torch.Tensor, torch.Tensor],
    extrin: torch.Tensor,       # [B, 3, 4]
    intrin: torch.Tensor,       # [B, 3, 3]
    face_index: torch.Tensor,   # [T, T]
    index_image: torch.Tensor,  # [T, T, 3]
    bary_image: torch.Tensor,   # [T, T, 3]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unproject camera images into UV; returns (tex, visibility mask)."""
    geom, faces = ply
    v_pix = transform(geom, intrin, extrin)
    index_img = torch.stack([
        rasterize(vp, rl.vi, rl.h, rl.w, **rl.raster_kwargs)
        for vp in v_pix])
    return compute_view_texture(
        geom, faces, image, index_img, None, intrin, extrin,
        index_image, bary_image, face_index,
        intensity_threshold=None, normal_threshold=0.1,
    )
