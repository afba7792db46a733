"""Raymarcher facade over the MVP march (port of the JAX package's
utils/render_raymarcher.py; reference ca_code/utils/render_raymarcher.py).

Normalizes the prims' positions and the culling camera's translation by
volradius, zeroes the alphas of invalid prims (``valid_prims``), marches
each sample of the batch in turn (``ops/mvp.mvp_raymarch_tiled``) and
returns NCHW rgb and alpha.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from goliath_torch.ops.mvp import mvp_raymarch_tiled


class Raymarcher:
    def __init__(self, volradius: float, dt: float = 1.0, **march_kwargs):
        self.volume_radius = volradius
        self.dt = dt / volradius
        self.march_kwargs = march_kwargs

    def __call__(
        self,
        raypos: torch.Tensor,     # [B, H, W, 3] (normalized volume frame)
        raydir: torch.Tensor,     # [B, H, W, 3]
        tminmax: torch.Tensor,    # [B, H, W, 2]
        decout: Dict[str, torch.Tensor],
        K: torch.Tensor,          # [B, 3, 3] for tile culling
        Rt: torch.Tensor,         # [B, 3, 4]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(rgb [B, 3, H, W], alpha [B, 1, H, W], rgba, None); ``decout``
        holds primpos, primrot, primscale, primrgba [B, K, 4, TD, TH, TW]
        and optionally valid_prims [K] and a warp field [B, K, 3, ...]."""
        primpos = decout["primpos"] / self.volume_radius
        template = decout["primrgba"]
        if decout.get("valid_prims", None) is not None:
            vp = decout["valid_prims"].to(template.dtype)       # [K]
            template = torch.cat(
                [template[:, :, :3],
                 template[:, :, 3:] * vp[None, :, None, None, None, None]], 2)
        # the culling camera works in the normalized frame
        Rt_n = torch.cat([Rt[:, :, :3], Rt[:, :, 3:] / self.volume_radius], 2)
        warp = decout.get("warp", None)
        rayrgba = torch.stack([
            mvp_raymarch_tiled(
                raypos[b], raydir[b], self.dt, tminmax[b], primpos[b],
                decout["primrot"][b], decout["primscale"][b], template[b],
                K[b], Rt_n[b], warp=None if warp is None else warp[b],
                **self.march_kwargs)
            for b in range(raypos.shape[0])])                   # [B, 4, H, W]
        return rayrgba[:, :3], rayrgba[:, 3:4], rayrgba, None

    def window_overflow(self, decout: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Share of prims whose box diagonal exceeds the sampling window
        (``window_steps`` * dt), the march's exactness bound; 0 when no
        window is set. primscale is learned, so prims can outgrow the
        window in training and lose their tails silently."""
        Sp = self.march_kwargs.get("window_steps", None)
        pscale = decout["primscale"]                  # [B, K, 3] (1/extent)
        if Sp is None:
            return pscale.new_zeros(())
        # oriented half-extents are 1/primscale in the normalized frame
        diam = 2.0 * torch.linalg.norm(
            1.0 / pscale.abs().clamp(min=1e-12), dim=-1)
        return (diam > Sp * self.dt).float().mean()
