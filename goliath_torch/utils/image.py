"""Image utilities (port of the JAX package's utils/image.py, the part the
ported losses, summaries and models call: the color pipeline (linear <->
sRGB, the mugsy color correction, the display mapping), ``jnp.clip``'s
and ``jnp.maximum``'s ties, ``jnp.abs``'s gradient at 0, mask morphology,
the difference-image remap and the host-side gaussian blur of mesh_vae's
texture mean). The labeled image grids of the visualization scripts come
with those scripts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_WB_SCALE = np.array([1.05, 0.95, 1.45], dtype=np.float32)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``x`` clipped to [lo, hi] with ``jnp.clip``'s gradient: a maximum
    then a minimum, each giving half the gradient to ``x`` where ``x``
    equals the bound (``torch.clamp`` gives all of it there). It matters
    where values sit exactly on a bound, as a render's background at 0."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: half the gradient where ``x`` is 0 exactly
    (``clamp(min=0)`` gives all of it there, ``F.relu`` none)."""
    return torch.maximum(x, x.new_zeros(()))


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: |x| whose gradient at exactly 0 is +1 (``torch.abs``
    gives 0 there). It matters where a function starts at its kink:
    ``learn_blur``'s weights are initialized to exactly 1."""
    return torch.where(x >= 0, x, -x)


def linear2srgb(img: torch.Tensor, gamma: float = 2.4) -> torch.Tensor:
    linear_part = img * 12.92
    exp_part = 1.055 * torch.pow(img.clamp(min=0.0031308), 1.0 / gamma) - 0.055
    return torch.where(img <= 0.0031308, linear_part, exp_part)


def srgb2linear(img: torch.Tensor, gamma: float = 2.4) -> torch.Tensor:
    linear_part = img / 12.92
    exp_part = torch.pow((img.clamp(min=0.04045) + 0.055) / 1.055, gamma)
    return torch.where(img <= 0.04045, linear_part, exp_part)


def linear2color_corr(img: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Ad-hoc mugsy color correction and gamma; ``dim`` is the channel
    axis."""
    gamma = 2.0
    black = 3.0 / 255.0
    scale_shape = [1] * img.dim()
    scale_shape[dim] = 3
    scale = torch.tensor([1.4, 1.1, 1.6], dtype=img.dtype,
                         device=img.device).reshape(scale_shape)
    img = img * scale / 1.1
    return torch.clamp(
        torch.pow((1.0 / (1 - black)) * 0.95
                  * torch.clamp(img - black, 0, 2), 1.0 / gamma)
        - 15.0 / 255.0, 0, 2)


def linear2display(val: torch.Tensor, gamma: float = 1.5,
                   wbscale: np.ndarray = DEFAULT_WB_SCALE,
                   black: float = 5.0 / 255.0, mode: str = "srgb"
                   ) -> torch.Tensor:
    """[B, 3, H, W] raw-linear [0, 255] -> display [0, 255]."""
    scaling = torch.as_tensor(np.asarray(wbscale, np.float32),
                              device=val.device)[None, :, None, None]
    val = val.float() / 255.0 * scaling - black
    if mode == "srgb":
        val = linear2srgb(val, gamma=gamma)
    else:
        val = torch.pow(val.clamp(min=0.0), 1.0 / gamma)
    return torch.clamp(val, 0, 1) * 255.0


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


def gaussian_blur_np(x: np.ndarray, ksize: int) -> np.ndarray:
    """Host-side gaussian blur of [B, C, H, W] with torchvision's default
    sigma = 0.3*((k-1)*0.5 - 1) + 0.8 (scipy, as the JAX package)."""
    from scipy import ndimage

    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    out = np.empty_like(x)
    for b in range(x.shape[0]):
        for c in range(x.shape[1]):
            out[b, c] = ndimage.gaussian_filter(x[b, c], sigma,
                                                truncate=ksize / (2 * sigma))
    return out
