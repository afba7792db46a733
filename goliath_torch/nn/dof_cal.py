"""Per-camera learnable defocus blur (port of the JAX package's
nn/dof_cal.py).

Softmax mix of {identity, 3x3 gaussian blur, 7x7 gaussian blur} per camera;
``reg`` exposes the raw weights for the ``learn_blur`` loss.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _gauss_taps(ksize: int) -> tuple:
    # torchvision gaussian_blur default sigma: 0.3*((k-1)*0.5 - 1) + 0.8
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - ksize // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return tuple(float(v) for v in g)


def gaussian_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """[B, C, H, W] gaussian blur, 'same' zero padding: separable
    shift-and-add, rows then columns, as the JAX package writes it."""
    taps = _gauss_taps(ksize)
    r = ksize // 2
    H, W = img.shape[2], img.shape[3]
    xp = F.pad(img, (0, 0, r, r))
    acc = None
    for k in range(ksize):
        term = taps[k] * xp[:, :, k:k + H]
        acc = term if acc is None else acc + term
    xp = F.pad(acc, (r, r, 0, 0))
    acc = None
    for k in range(ksize):
        term = taps[k] * xp[:, :, :, k:k + W]
        acc = term if acc is None else acc + term
    return acc


class LearnableBlur(nn.Module):
    def __init__(self, cameras: Sequence[str]):
        super().__init__()
        self.cameras: List[str] = [str(c) for c in cameras]
        self.weights_raw = nn.Parameter(torch.ones(len(self.cameras), 3))

    def name_to_idx(self, cam_names: Sequence[str]) -> torch.Tensor:
        return torch.tensor([self.cameras.index(str(c)) for c in cam_names],
                            dtype=torch.int32, device=self.weights_raw.device)

    def reg(self, cam_idxs: torch.Tensor) -> torch.Tensor:
        return self.weights_raw[cam_idxs.long()]

    def forward(self, img: torch.Tensor, cam_idxs: torch.Tensor
                ) -> torch.Tensor:
        B = img.shape[0]
        weights = torch.softmax(self.weights_raw[cam_idxs.long()], dim=-1)
        weights = weights.reshape(B, 3, 1, 1, 1)
        return (weights[:, 0] * img
                + weights[:, 1] * gaussian_blur(img, 3)
                + weights[:, 2] * gaussian_blur(img, 7))
