"""Image utilities (port of the JAX package's utils/image.py, the part the
ported losses, summaries and models call: the color pipeline (linear <->
sRGB, the mugsy color correction, the display mapping), ``jnp.clip``'s
and ``jnp.maximum``'s ties, ``jnp.abs``'s gradient at 0, mask morphology,
the difference-image remap, ``smoothstep``, the host-side gaussian blur of
mesh_vae's texture mean and erosion) and the numpy grids of summaries
(``make_grid_np``, and ``make_image_grid_batched`` with its 3x5 label
font).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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


def smoothstep(e0, e1, x: torch.Tensor) -> torch.Tensor:
    t = clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


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


def morph_erode_np(x: np.ndarray, ks: int) -> np.ndarray:
    """numpy binary erosion (a ks x ks square) for host-side mask prep."""
    from scipy import ndimage

    return ndimage.binary_erosion(x > 0, np.ones((ks, ks))).astype(x.dtype)


def tensor2rgb_np(x: np.ndarray) -> np.ndarray:
    """[C, H, W] float in [0, 1] -> [H, W, 3] uint8."""
    if x.shape[0] == 1:
        x = np.repeat(x, 3, axis=0)
    x = np.clip(x[:3], 0.0, 1.0)
    return (x.transpose(1, 2, 0) * 255.0).astype(np.uint8)


def make_grid_np(images: np.ndarray, nrow: int = 8, pad: int = 2
                 ) -> np.ndarray:
    """[N, C, H, W] -> one [C, H', W'] grid (torchvision's make_grid)."""
    n, c, h, w = images.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    grid = np.zeros((c, nr * (h + pad) + pad, ncol * (w + pad) + pad),
                    images.dtype)
    for i in range(n):
        r, cc = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + cc * (w + pad)
        grid[:, y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def make_image_grid_batched(
    data: Dict[str, np.ndarray],
    max_row_hight: Optional[int] = None,
    input_is_in_0_1: bool = False,
) -> np.ndarray:
    """Labeled rows: one row per dict key, one column per batch element.
    Takes [B, C, H, W] (or [B, H, W]) float arrays; returns [H', W', 3]
    uint8."""
    rows: List[np.ndarray] = []
    for key, val in data.items():
        val = np.asarray(val, dtype=np.float32)
        if val.ndim == 3:
            val = val[:, None]
        if not input_is_in_0_1:
            val = val / 255.0
        row = np.concatenate([tensor2rgb_np(v) for v in val], axis=1)
        if max_row_hight is not None and row.shape[0] > max_row_hight:
            sc = max_row_hight / row.shape[0]
            new_w = max(1, int(row.shape[1] * sc))
            row = _resize_np(row, (max_row_hight, new_w))
        rows.append(_draw_label(row, key))
    max_w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, max_w - r.shape[1]), (0, 0)))
            for r in rows]
    return np.concatenate(rows, axis=0)


def _resize_np(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of [H, W, 3] uint8."""
    h, w = img.shape[:2]
    ys = (np.arange(size[0]) * (h / size[0])).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(size[1]) * (w / size[1])).astype(np.int64).clip(0, w - 1)
    return img[ys][:, xs]


def _draw_label(img: np.ndarray, text: str) -> np.ndarray:
    """A 12-pixel label strip in the 3x5 bitmap font above a row."""
    strip = np.zeros((12, img.shape[1], 3), dtype=np.uint8)
    _render_text(strip, text.upper()[: img.shape[1] // 6], 2, 2)
    return np.concatenate([strip, img], axis=0)


# 3x5 bitmap font, row-major bits per character
_FONT = {
    "A": "111101111101101", "B": "110101110101110", "C": "111100100100111",
    "D": "110101101101110", "E": "111100110100111", "F": "111100110100100",
    "G": "111100101101111", "H": "101101111101101", "I": "111010010010111",
    "J": "001001001101111", "K": "101110100110101", "L": "100100100100111",
    "M": "101111111101101", "N": "101111111111101", "O": "111101101101111",
    "P": "111101111100100", "Q": "111101101111001", "R": "111101110110101",
    "S": "111100111001111", "T": "111010010010010", "U": "101101101101111",
    "V": "101101101101010", "W": "101101111111101", "X": "101101010101101",
    "Y": "101101111001111", "Z": "111001010100111", "_": "000000000000111",
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111", " ": "000000000000000", "-": "000000111000000",
    ".": "000000000000010",
}


def _render_text(canvas: np.ndarray, text: str, x0: int, y0: int) -> None:
    for i, ch in enumerate(text):
        bits = _FONT.get(ch, _FONT[" "])
        for j, b in enumerate(bits):
            if b == "1":
                y = y0 + j // 3
                x = x0 + i * 4 + j % 3
                if y < canvas.shape[0] and x < canvas.shape[1]:
                    canvas[y, x] = 255
