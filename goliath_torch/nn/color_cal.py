"""Per-camera color calibration (port of the JAX package's nn/color_cal.py,
``CalV5``).

Per-camera affine (3 gains + 3 biases) with an identity passthrough camera;
grayscale cameras (id prefix "41") collapse to luma. Vectorized over the
batch as in the JAX package: a masked select plus ``scale_grad``, which
scales the gradient that reaches a sample's parameters (1 for the identity
camera, ``gs_lrscale`` for grayscale cameras, ``col_lrscale`` otherwise).
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

logger = logging.getLogger(__name__)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        return g * scale, None


def scale_grad(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Identity whose gradient with respect to ``x`` is multiplied by
    ``scale`` (broadcast against ``x``)."""
    return _ScaleGrad.apply(x, scale)


class CalV5(nn.Module):
    def __init__(self, cameras: Sequence[str], identity_camera: str,
                 gs_lrscale: float = 1e0, col_lrscale: float = 1e-1):
        super().__init__()
        self.cameras: List[str] = [str(c) for c in cameras]
        identity_camera = str(identity_camera)
        if identity_camera not in self.cameras:
            identity_camera = self.cameras[0]
            logger.warning(
                "Requested color-calibration identity camera not present, "
                f"defaulting to {identity_camera}.")
        self.identity_idx = self.cameras.index(identity_camera)
        self.gs_lrscale = gs_lrscale
        self.col_lrscale = col_lrscale
        grey = np.asarray([c.startswith("41") for c in self.cameras], bool)
        self.register_buffer("grey_mask", torch.from_numpy(grey),
                             persistent=False)
        init = np.tile(np.asarray([1, 1, 1, 0, 0, 0], np.float32),
                       (len(self.cameras), 1))
        init[grey, :3] = np.asarray([0.37, 0.52, 0.52], np.float32)
        self.cal_params = nn.Parameter(torch.from_numpy(init))

    def name_to_idx(self, cam_names: Sequence[str]) -> torch.Tensor:
        return torch.tensor([self.cameras.index(str(c)) for c in cam_names],
                            dtype=torch.int32, device=self.cal_params.device)

    def forward(self, image: torch.Tensor, cam_idxs: torch.Tensor
                ) -> torch.Tensor:
        """image [B, 3, H, W], cam_idxs [B] int."""
        cam_idxs = cam_idxs.long()
        grey = self.grey_mask[cam_idxs]                       # [B]
        is_identity = cam_idxs == self.identity_idx
        hook_scales = torch.where(
            is_identity, 1.0,
            torch.where(grey, self.gs_lrscale, self.col_lrscale))
        params = scale_grad(self.cal_params[cam_idxs],
                            hook_scales[:, None].to(image.dtype))  # [B, 6]
        w = params[:, :3, None, None]
        b = params[:, 3:, None, None]
        color_out = image * w + b
        grey_out = (torch.sum(image * w, dim=1, keepdim=True)
                    + torch.sum(b, dim=1, keepdim=True)).expand_as(image)
        out = torch.where(grey[:, None, None, None], grey_out, color_out)
        return torch.where(is_identity[:, None, None, None], image, out)
