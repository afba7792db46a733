"""Raster shadow maps (port of the JAX package's utils/shadowmap.py).

Renders depth from each light's viewpoint with the mesh rasterizer (K5 once
per light view, its binning on K4), then projects the shaded points (a UV
position map) into the light view and compares depths with a 3x3
gaussian-weighted soft test; optional sigmoid backface culling.

The taps are the JAX package's: nearest samples at exact +-1-texel offsets
of one base texel (``round`` half to even in both packages), fetched for
each point in one gather of 18 channel-last values (9 taps x depth and
coverage). Points whose base texel lies outside the light's frame lose
every tap.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from goliath_torch.ops.rasterizer import RenderLayer, rasterize, \
    render_barys, transform
from goliath_torch.utils.geom import project_points_multi

KERNEL = 3
_SIGMA = 0.3 * ((KERNEL - 1) * 0.5 - 1) + 0.8
# the soft compare's tap weights, row-major over the 3x3 offsets
TAP_WEIGHTS = tuple(
    math.exp(-((x - KERNEL // 2) ** 2 + (y - KERNEL // 2) ** 2)
             / (2.0 * _SIGMA**2))
    for y in range(KERNEL) for x in range(KERNEL))


def fit_light_camera(rl: RenderLayer, Rt: torch.Tensor, verts: torch.Tensor
                     ) -> torch.Tensor:
    """Intrinsics [B, 3, 3] of the light views Rt [B, 3, 4] whose focal
    fits verts [B, V, 3] into the rl.h x rl.w frame with a 1.02 margin."""
    B = Rt.shape[0]
    focal = 1000.0
    K = torch.zeros((B, 3, 3), dtype=verts.dtype, device=verts.device)
    K[:, 0, 0] = focal
    K[:, 1, 1] = focal
    K[:, 0, 2] = rl.w / 2
    K[:, 1, 2] = rl.h / 2
    K[:, 2, 2] = 1.0
    v_pix, _ = project_points_multi(verts, Rt[:, None], K[:, None])
    v_pix = v_pix[:, 0]
    center = verts.new_tensor([rl.w, rl.h]) / 2
    pix_ratio = 1.02 * (v_pix[..., :2] - center[None, None]) \
        / center[None, None]
    fit = focal / pix_ratio.abs().amax(dim=(1, 2)).clamp(min=1e-6)
    K[:, 0, 0] = fit
    K[:, 1, 1] = fit
    return K


def nearest_taps(p_pix: torch.Tensor, hs: int, ws: int, H: int, W: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base texel (bx, by) [B, H, W] int of the nearest taps of the points
    at light-view pixels p_pix [B, H*W, 2] in an hs x ws depth image
    (grid_sample's nearest, align_corners=False), with the JAX package's
    arithmetic step by step."""
    B = p_pix.shape[0]
    vp = p_pix.reshape(B, H, W, 2)
    vx = (vp[..., 0] - ws / 2.0 - 0.5) / (ws / 2.0)
    vy = (vp[..., 1] - hs / 2.0 - 0.5) / (hs / 2.0)
    bx = torch.round((vx + 1.0) * ws * 0.5 - 0.5).to(torch.int32)
    by = torch.round((vy + 1.0) * hs * 0.5 - 0.5).to(torch.int32)
    return bx, by


@torch.no_grad()
def get_shadow_map(
    rl: RenderLayer,
    Rt: torch.Tensor,        # [B, 3, 4] light views
    K_unused: Optional[torch.Tensor],
    verts: torch.Tensor,     # [B, V, 3]
    postex: torch.Tensor,    # [B, 3, H, W] shaded-point position map
    nml: Optional[torch.Tensor] = None,  # [B, 3, H, W] normals (cull)
) -> torch.Tensor:
    """In-shadow depth difference [B, 1, H, W] (>= 0; 1e3 blended in where
    a point faces away from its light). Takes no gradient, as the JAX
    package's callers stop it."""
    B, _, H, W = postex.shape
    K = fit_light_camera(rl, Rt, verts)

    points = postex.permute(0, 2, 3, 1).reshape(B, -1, 3)
    p_pix, p_cam = project_points_multi(points, Rt[:, None], K[:, None])
    p_pix = p_pix[:, 0]
    p_cam = p_cam[:, 0]

    # depth render from each light: one z-buffer launch a view
    v_pix_l = transform(verts, K, Rt)
    depth = torch.stack([
        render_barys(vp, rl.vi, rasterize(vp, rl.vi, rl.h, rl.w,
                                          **rl.raster_kwargs))[0]
        for vp in v_pix_l])[:, None]                   # [B, 1, h, w]

    v_depth_1 = p_cam.reshape(B, H, W)
    hs, ws = depth.shape[2], depth.shape[3]
    bx, by = nearest_taps(p_pix, hs, ws, H, W)

    if nml is not None:
        light_pos = -torch.einsum("bji,bj->bi", Rt[:, :3, :3], Rt[:, :3, 3])
        v_dir = light_pos[:, :, None, None] - postex
        v_dir = v_dir / torch.linalg.norm(v_dir, dim=1,
                                          keepdim=True).clamp(min=1e-12)
        nv_dot = torch.sum(nml * v_dir, dim=1, keepdim=True)
        bcull = torch.sigmoid(10.0 * nv_dot)

    # the 9 shifted (depth, coverage) planes, channel-last, so that each
    # point fetches its 18 values as one row
    dmask = (depth > 0.0).to(postex.dtype)
    dm_p = F.pad(torch.cat([depth, dmask], dim=1), (1, 1, 1, 1))
    stacked = torch.cat([dm_p[:, :, y:y + hs, x:x + ws]
                         for y in range(KERNEL) for x in range(KERNEL)],
                        dim=1)                         # [B, 18, h, w]
    cl = stacked.reshape(B, 2 * KERNEL * KERNEL, hs * ws).transpose(1, 2)
    base_ok = ((bx >= 0) & (bx < ws) & (by >= 0) & (by < hs)).to(
        postex.dtype)
    idx = by.clamp(0, hs - 1).long() * ws + bx.clamp(0, ws - 1).long()
    rows = torch.gather(cl, 1, idx.reshape(B, -1, 1).expand(
        -1, -1, cl.shape[2]))                          # [B, P, 18]
    rows = rows * base_ok.reshape(B, -1, 1)
    d9 = rows[..., 0::2].reshape(B, H, W, KERNEL * KERNEL)
    w9 = rows[..., 1::2].reshape(B, H, W, KERNEL * KERNEL)
    wt = postex.new_tensor(TAP_WEIGHTS)
    v2 = d9 / (w9 + 1e-8)
    valid = wt * (w9 > 1e-4).to(postex.dtype)
    v1 = v_depth_1[..., None]                          # [B, H, W, 1]
    shadow_sum = torch.sum(valid * (v1 - v2).clamp(min=0.0), dim=-1)
    valid_sum = torch.sum(valid, dim=-1)
    in_shadow = (shadow_sum / (valid_sum + 1e-6))[:, None]
    if nml is not None:
        in_shadow = bcull * in_shadow + (1.0 - bcull) * 1e3
    return in_shadow
