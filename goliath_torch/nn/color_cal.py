"""Per-camera color calibration (port of the JAX package's
nn/color_cal.py).

Each variant holds ``cal_params``, one affine per camera (3 gains + 3
biases), initialised to the identity, and an identity camera (the first
camera, with a warning, where the named one is missing). ``CalV5``: the
identity camera passes its image through; grayscale cameras (id prefix
"41") collapse to luma. Vectorized over the batch as in the JAX package: a
masked select plus ``scale_grad``, which scales the gradient that reaches a
sample's parameters (1 for the identity camera, ``gs_lrscale`` for
grayscale cameras, ``col_lrscale`` otherwise). ``CalV3``: the affine of
every camera, the identity camera's row detached. ``CalV6``: the identity
camera's row replaced by the constant identity before the gather; refuses
grayscale cameras. ``Identity``: the image unchanged. ``make_cal`` builds
one by name.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

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


IDENTITY_AFFINE = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)


class _Cal(nn.Module):
    """The camera table, the identity camera's index (None where
    ``identity_camera`` is) and ``cal_params`` (the identity affine for
    every camera)."""

    def __init__(self, cameras: Sequence[str],
                 identity_camera: Optional[str]):
        super().__init__()
        self.cameras: List[str] = [str(c) for c in cameras]
        self.cal_params = nn.Parameter(torch.tensor(
            [IDENTITY_AFFINE] * len(self.cameras), dtype=torch.float32))
        self.identity_idx = None
        if identity_camera is None:
            return
        identity_camera = str(identity_camera)
        if identity_camera not in self.cameras:
            identity_camera = self.cameras[0]
            logger.warning(
                "Requested color-calibration identity camera not present, "
                f"defaulting to {identity_camera}.")
        self.identity_idx = self.cameras.index(identity_camera)

    def name_to_idx(self, cam_names: Sequence[str]) -> torch.Tensor:
        return torch.tensor([self.cameras.index(str(c)) for c in cam_names],
                            dtype=torch.int32, device=self.cal_params.device)


def _affine(image: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    return image * params[:, :3, None, None] + params[:, 3:, None, None]


class CalV5(_Cal):
    def __init__(self, cameras: Sequence[str], identity_camera: str,
                 gs_lrscale: float = 1e0, col_lrscale: float = 1e-1):
        super().__init__(cameras, identity_camera)
        self.gs_lrscale = gs_lrscale
        self.col_lrscale = col_lrscale
        grey = np.asarray([c.startswith("41") for c in self.cameras], bool)
        self.register_buffer("grey_mask", torch.from_numpy(grey),
                             persistent=False)
        with torch.no_grad():
            self.cal_params[torch.from_numpy(grey), :3] = torch.tensor(
                [0.37, 0.52, 0.52])

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


class CalV3(_Cal):
    """The affine of each sample's camera; the identity camera's row is
    detached (it keeps its initial identity unless set by hand)."""

    def forward(self, image: torch.Tensor, cam_idxs: torch.Tensor
                ) -> torch.Tensor:
        cam_idxs = cam_idxs.long()
        params = self.cal_params[cam_idxs]
        is_identity = (cam_idxs == self.identity_idx)[:, None]
        return _affine(image, torch.where(is_identity, params.detach(),
                                          params))


class CalV6(_Cal):
    """The affine of each sample's camera, the identity camera's row the
    constant identity (it takes no gradient). No grayscale cameras."""

    def __init__(self, cameras: Sequence[str], identity_camera: str):
        if any(str(c).startswith("41") for c in cameras):
            raise ValueError("Gray cameras are not supported")
        super().__init__(cameras, identity_camera)

    def forward(self, image: torch.Tensor, cam_idxs: torch.Tensor
                ) -> torch.Tensor:
        ident = torch.tensor(IDENTITY_AFFINE, dtype=self.cal_params.dtype,
                             device=self.cal_params.device)
        is_identity = torch.arange(len(self.cameras),
                                   device=ident.device) == self.identity_idx
        table = torch.where(is_identity[:, None], ident[None],
                            self.cal_params)
        return _affine(image, table[cam_idxs.long()])


class Identity(_Cal):
    """No calibration; keeps the parameter table (and reads no identity
    camera)."""

    def __init__(self, cameras: Sequence[str], identity_camera: str):
        super().__init__(cameras, None)

    def forward(self, image: torch.Tensor, cam_idxs: torch.Tensor
                ) -> torch.Tensor:
        return image


def make_cal(cal_type: str, **kwargs) -> nn.Module:
    return {"identity": Identity, "v3": CalV3, "v5": CalV5,
            "v6": CalV6}[cal_type](**kwargs)
