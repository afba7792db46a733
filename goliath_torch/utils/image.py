"""Image utilities (port of the JAX package's utils/image.py, the part the
ported losses and summaries call: mask morphology, the sRGB curve and the
difference-image remap). The rest of the color pipeline comes with the
paths that use it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear2srgb(img: torch.Tensor, gamma: float = 2.4) -> torch.Tensor:
    linear_part = img * 12.92
    exp_part = 1.055 * torch.pow(img.clamp(min=0.0031308), 1.0 / gamma) - 0.055
    return torch.where(img <= 0.0031308, linear_part, exp_part)


def scale_diff_image(diff_img: torch.Tensor) -> torch.Tensor:
    """Remap a signed difference image to [0, max] for display."""
    mval = diff_img.abs().max()
    half = torch.where(mval > 1, 128.0, 0.5)
    top = torch.where(mval > 1, 255.0, 1.0)
    out = half * (diff_img / mval.clamp(min=1e-12)) + half
    return torch.minimum(out.clamp(min=0.0), top)


def dilate(x: torch.Tensor, ks: int) -> torch.Tensor:
    """Binary dilation with a ks x ks box. x: [B, H, W] or [B, 1, H, W]."""
    if ks % 2 != 1:
        raise ValueError(f"dilate takes an odd box size, got {ks}")
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, None]
    pad = ks // 2
    out = F.max_pool2d((x > 0).float(), ks, stride=1, padding=pad) > 0
    if squeeze:
        out = out[:, 0]
    return out.to(x.dtype)


def erode(x: torch.Tensor, ks: int) -> torch.Tensor:
    if x.dtype == torch.bool:
        return ~dilate(~x, ks)
    return 1 - dilate(1 - x, ks)
