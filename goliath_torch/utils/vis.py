"""Visualization helpers: keypoints, heatmaps, colormaps, depth and scalar
maps (port of the JAX package's utils/vis.py).

The keypoint -> heatmap ops are torch (they run on the batch's device);
the colormaps and the drawing helpers are host-side numpy, copied from the
JAX package (which draws without cv2: vectorized disc and line rasterizers
with cv2's semantics), so both give the same bytes. The host helpers take
numpy arrays or tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

Color = Tuple[float, float, float]


# -------------------------------------------------------------- torch ops


def kpts2delta(kpts: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """[B, N, 2] keypoints -> [B, N, H, W, 2] vectors from each grid cell
    to each keypoint."""
    h, w = size
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=kpts.dtype, device=kpts.device),
        torch.arange(w, dtype=kpts.dtype, device=kpts.device), indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)  # [H, W, 2] as (x, y)
    return kpts[:, :, None, None, :] - grid[None, None]


def kpts2heatmap(kpts: torch.Tensor, size: Sequence[int],
                 sigma: int = 7) -> torch.Tensor:
    """Gaussian keypoint heatmaps [B, N, H, W]."""
    dist = torch.sum(torch.square(kpts2delta(kpts, size)), dim=-1)
    return torch.exp(-dist / (2.0 * sigma**2))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


# ------------------------------------------------------------ colormaps


def _jet_colormap() -> np.ndarray:
    """256x3 uint8 jet lookup (matches cv2.COLORMAP_JET's piecewise ramp,
    reference image.py:599-603 get_color_map)."""
    x = np.linspace(0.0, 1.0, 256)

    def ramp(v):
        return np.clip(1.5 - np.abs(v), 0.0, 1.0)

    r = ramp(4.0 * (x - 0.75))
    g = ramp(4.0 * (x - 0.5))
    b = ramp(4.0 * (x - 0.25))
    return np.rint(np.stack([r, g, b], axis=1) * 255.0).astype(np.uint8)


_COLOR_MAPS = {"COLORMAP_JET": _jet_colormap}


def get_color_map(name: str = "COLORMAP_JET") -> np.ndarray:
    """[256, 3] uint8 RGB lookup table (reference image.py:599-603)."""
    return _COLOR_MAPS[name]()


def tensor2rgbjet(x: Union[np.ndarray, torch.Tensor],
                  x_max: Optional[float] = None,
                  x_min: Optional[float] = None) -> np.ndarray:
    """Scalar map [H, W] (or [1, H, W]) -> jet-colored uint8 [H, W, 3]
    (reference image.py:435-451)."""
    x = np.asarray(_host(x), np.float32)
    x = x.reshape(x.shape[-2:])
    lo = float(x.min()) if x_min is None else x_min
    hi = float(x.max()) if x_max is None else x_max
    t = np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    idx = (t * 255.0).astype(np.int32)
    return get_color_map()[idx]


def tensor2rgb(x: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """Normalize a scalar/feature map to uint8 grayscale RGB [H, W, 3]
    (reference image.py:454-478)."""
    x = np.asarray(_host(x), np.float32)
    x = x.reshape(x.shape[-2:])
    lo, hi = float(x.min()), float(x.max())
    t = (x - lo) / max(hi - lo, 1e-12)
    g = (t * 255.0).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def feature2rgb(x: Union[np.ndarray, torch.Tensor], scale: int = -1
                ) -> np.ndarray:
    """First-3-channels feature visualization (reference image.py:606-618):
    per-channel min/max normalize -> uint8 RGB, optional nearest upscale."""
    x = np.asarray(_host(x), np.float32)
    if x.ndim == 4:
        x = x[0]
    c = min(3, x.shape[0])
    chans = []
    for i in range(3):
        ch = x[min(i, c - 1)]
        lo, hi = float(ch.min()), float(ch.max())
        chans.append((ch - lo) / max(hi - lo, 1e-12))
    rgb = (np.stack(chans, axis=-1) * 255.0).astype(np.uint8)
    if scale > 1:
        rgb = np.repeat(np.repeat(rgb, scale, axis=0), scale, axis=1)
    return rgb


def visualize_scalar_image(img: np.ndarray, min_val: float,
                           val_range: float,
                           color_map: str = "COLORMAP_JET",
                           convert_to_rgb: bool = True) -> np.ndarray:
    """Clamp-normalize a scalar image and colorize it
    (reference image.py:940-954)."""
    t = np.clip((np.asarray(_host(img), np.float32) - min_val)
                / max(val_range, 1e-12), 0.0, 1.0)
    idx = (t * 255.0).astype(np.int32).reshape(t.shape[-2:])
    out = get_color_map(color_map)[idx]
    if not convert_to_rgb:
        out = out[..., ::-1]
    return out


def process_depth_image(depth_img: np.ndarray, depth_max: float,
                        depth_err_range: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero out-of-range depths; return (clean depth, normalized error map)
    (reference image.py:957-967)."""
    depth_img = np.asarray(_host(depth_img), np.float32)
    valid = np.logical_and(depth_img > 0, depth_img <= depth_max)
    clean = np.where(valid, depth_img, 0.0)
    err = np.abs(clean - depth_img) / depth_err_range
    return clean, err


def resize_to_match(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-resize an [H, W, C] uint8 image to (h, w)
    (reference image.py:876-913, sans cv2)."""
    h, w = size
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


def tensor_to_rgb_array(x: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """[B, C, H, W] -> [B, H, W, C] numpy (reference image.py:984-988)."""
    return np.asarray(_host(x)).transpose(0, 2, 3, 1)


# ----------------------------------------------------- drawing (numpy)


def _disc_mask(h: int, w: int, cx: int, cy: int, r: int) -> np.ndarray:
    """Boolean [h, w] filled-disc mask; fully vectorized, clipped."""
    y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
    x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
    m = np.zeros((h, w), bool)
    if y0 >= y1 or x0 >= x1:
        return m
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m[y0:y1, x0:x1] = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return m


def draw_keypoints(img: np.ndarray, kpt: np.ndarray,
                   kpt_w: float) -> np.ndarray:
    """Confidence-weighted green/magenta keypoint discs, drawn in place
    (reference image.py:970-981: color = (-255, 255, -255) * conf * kpt_w,
    radius-2 filled circles, additive into the image)."""
    h, w = img.shape[:2]
    x, y, conf = kpt[:, 0], kpt[:, 1], kpt[:, 2] * kpt_w
    col = np.array([-255.0, 255.0, -255.0]) * conf[:, None]
    for (xi, yi), c in zip(np.column_stack([x, y]).astype(np.int32), col):
        m = _disc_mask(h, w, int(xi), int(yi), 2)
        img[m] = np.clip(img[m] + c, 0, 255)
    return img


def draw_keypoints_with_color(image: np.ndarray, keypoints_uvw: np.ndarray,
                              color: Color) -> np.ndarray:
    """Fixed-color keypoint discs, additive with overlap support
    (reference image.py:991-1003)."""
    assert image.ndim == 3 and image.shape[-1] == 3
    h, w = image.shape[:2]
    overlay = np.zeros(image.shape, np.float32)
    for u, v in keypoints_uvw[:, :2].astype(np.int32):
        m = _disc_mask(h, w, int(u), int(v), 2)
        overlay[m] = color
    return np.clip(image.astype(np.float32) + overlay, 0.0, 255.0
                   ).astype(np.uint8)


def _draw_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
               color: Sequence[float]) -> None:
    """1-px line via dense parametric sampling (no cv2). cv2 drawing SETS
    pixels (saturating on uint8 images), so this writes clip(color, 0, 255)."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.round(np.linspace(p0[0], p1[0], n)).astype(np.int64)
    ys = np.round(np.linspace(p0[1], p1[1], n)).astype(np.int64)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys = xs[ok], ys[ok]
    img[ys, xs] = np.clip(np.asarray(color, np.float32), 0, 255)


def draw_contour(img: np.ndarray, contour_corrs: np.ndarray) -> np.ndarray:
    """Mesh-to-segment contour correspondences: red mesh-point discs, then
    blue lines drawn over them (reference image.py:1006-1026; cv2 circle and
    line both SET pixels, so the line overwrites the disc center)."""
    for corr in contour_corrs:
        mesh_uv, seg_uv = corr[1:3], corr[3:5]
        x, y = int(mesh_uv[0] + 0.5), int(mesh_uv[1] + 0.5)
        m = _disc_mask(img.shape[0], img.shape[1], x, y, 1)
        img[m] = np.array([255.0, 0.0, 0.0])
        _draw_line(img, (int(mesh_uv[0]), int(mesh_uv[1])),
                   (int(seg_uv[0]), int(seg_uv[1])), (-255.0, -255.0, 255.0))
    return img
