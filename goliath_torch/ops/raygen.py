"""Camera ray generation (port of the JAX package's ops/raygen.py).

Per-pixel ray directions and entry/exit parameters against the [-1, 1]^3
normalized volume, as elementwise tensor code (the reference's CUDA ray
generator, extensions/utils/utils_kernel.cu:11-51, computes the same).
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_raydirs(
    viewpos: torch.Tensor,      # [N, 3] camera position (world)
    viewrot: torch.Tensor,      # [N, 3, 3] world-to-cam rotation (rows = axes)
    focal: torch.Tensor,        # [N, 2] (fx, fy)
    princpt: torch.Tensor,      # [N, 2]
    pixelcoords: torch.Tensor,  # [N, H, W, 2]
    volradius: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (raypos [N,H,W,3], raydir [N,H,W,3], tminmax [N,H,W,2])."""
    N, H, W = pixelcoords.shape[:3]
    raypos = viewpos / volradius  # [N, 3]

    p = (pixelcoords - princpt[:, None, None]) / focal[:, None, None]
    d = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)  # cam space
    # rotate into world: d_world = R^T d == sum_k R[k] * d[k]
    d = torch.einsum("nkc,nhwk->nhwc", viewrot, d)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)

    rp = raypos[:, None, None]
    safe_d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t1 = (-1.0 - rp) / safe_d
    t2 = (1.0 - rp) / safe_d
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    tminmax = torch.stack([tmin.clamp(min=0.0), tmax], dim=-1)
    return rp.expand(N, H, W, 3), d, tminmax


def make_pixelcoords(N: int, H: int, W: int, dtype=torch.float32,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """[N, H, W, 2] pixel coordinates (x, y)."""
    y, x = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], -1)[None].expand(N, H, W, 2)
