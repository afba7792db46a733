"""UV-seam-continuous texture resampling (port of the JAX package's
utils/seams.py).

``SeamSampler`` holds precomputed seam-crossing texel copies (dst <- src)
and a weighted bilinear resample of the texels near a seam, both from the
static assets (``seam_data_1024`` / ``seam_data_2048``). Both stages touch
only a thin band of texels, so each is ``out = x + delta`` with ``delta``
gathered over the band's K texels and added back at them: gathers and one
``index_add`` over K texels per stage, with the JAX package's arithmetic
(``x + (src - dst)`` for the copy, ``x + w * (resampled - x)`` for the
resample), so both packages round alike. The backward is autograd's,
where the JAX package writes the transposed sparse maps by hand.

``impaint_batch`` and ``resample_tex`` are the same two stages as free
functions of the texel tables (the JAX package's dense oracles); they find
the band on every call, ``SeamSampler`` once.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device


def _as_np(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _copy_band(dst_ij, src_ij, W: int):
    """Flat (dst, src) texel indices of the copies dst <- src, dst
    deduplicated keeping its LAST occurrence (scatter-set semantics)."""
    dst_ij, src_ij = _as_np(dst_ij, np.int64), _as_np(src_ij, np.int64)
    dst = dst_ij[:, 0] * W + dst_ij[:, 1]
    src = src_ij[:, 0] * W + src_ij[:, 1]
    _, last = np.unique(dst[::-1], return_index=True)
    keep = np.sort(dst.size - 1 - last)
    return dst[keep], src[keep]


def _weights_2d(weights) -> np.ndarray:
    w = _as_np(weights, np.float32)
    return w.reshape(w.shape[-3:]) if w.ndim >= 3 else w[None]


def _resample_band(uvs, weights):
    """The texels with a non-zero weight (flat [K]), their weights
    [Cw, K] and the 4 taps (flat index [K], weight [K]) of
    grid_sample(align_corners=False, padding_mode='border') at their uv."""
    w2d = _weights_2d(weights)
    _, H, W = w2d.shape
    nz = np.nonzero(np.abs(w2d).max(axis=0) > 0)
    if nz[0].size == 0:
        nz = (np.zeros(1, np.int64), np.zeros(1, np.int64))
    uv = _as_np(uvs, np.float32)[nz[0], nz[1]]                 # [K, 2]
    x = uv[:, 0] * W - 0.5
    y = uv[:, 1] * H - 0.5
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = (x - x0).astype(np.float32), (y - y0).astype(np.float32)
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi = np.clip(x0 + dx, 0, W - 1).astype(np.int64)
            yi = np.clip(y0 + dy, 0, H - 1).astype(np.int64)
            tw = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            taps.append((yi * W + xi, tw.astype(np.float32)))
    return (nz[0] * W + nz[1], w2d[:, nz[0], nz[1]].astype(np.float32),
            taps)


def _on(device):
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dev


def _impaint_flat(xf: torch.Tensor, dst: torch.Tensor, src: torch.Tensor
                  ) -> torch.Tensor:
    """xf [B, C, N] with x[dst] += x[src] - x[dst] (dst unique)."""
    return xf.index_add(-1, dst, xf[..., src] - xf[..., dst])


def _resample_flat(xf: torch.Tensor, sel: torch.Tensor, sel_w: torch.Tensor,
                   taps) -> torch.Tensor:
    """xf [B, C, N] with x[sel] += w * (bilinear(taps) - x[sel])."""
    cur = xf[..., sel]
    res = None
    for idx, w in taps:
        term = xf[..., idx] * w
        res = term if res is None else res + term
    return xf.index_add(-1, sel, sel_w[None] * (res - cur))


def impaint_batch(value: torch.Tensor, dst_ij, src_ij) -> torch.Tensor:
    """Copy the src texels into the dst texels of value [B, C, H, W]
    (dst_ij, src_ij: [K, 2] (row, column), numpy or tensors; a repeated dst
    keeps its last copy). The texel tables are static assets: they take no
    gradient."""
    B, C, H, W = value.shape
    dst, src = (_on(value.device)(a) for a in _copy_band(dst_ij, src_ij, W))
    return _impaint_flat(value.reshape(B, C, H * W), dst, src).reshape(
        value.shape)


def resample_tex(tex: torch.Tensor, uvs, weights) -> torch.Tensor:
    """(1 - weights) * tex + weights * grid_sample(tex, 2 * uvs - 1,
    align_corners=False, padding_mode='border') of tex [B, C, H, W]
    (uvs [H, W, 2], weights [Cw, H, W] or [H, W]), computed over the texels
    of non-zero weight only. uvs and weights are static assets: they take
    no gradient."""
    B, C, H, W = tex.shape
    dev = _on(tex.device)
    sel, sel_w, taps = _resample_band(uvs, weights)
    return _resample_flat(tex.reshape(B, C, H * W), dev(sel), dev(sel_w),
                          [(dev(i), dev(w)) for i, w in taps]).reshape(
        tex.shape)


class SeamSampler:
    def __init__(self, seamless_data: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda") -> None:
        dev = _on(resolve_device(device))
        self.dst_ij = np.asarray(seamless_data["dst_ij"], np.int64)
        self.src_ij = np.asarray(seamless_data["src_ij"], np.int64)
        self.uvs = np.asarray(seamless_data["uvs"], np.float32)
        self.weights = np.asarray(seamless_data["weights"], np.float32)
        _, H, W = _weights_2d(self.weights).shape
        self._hw = (H, W)
        sel, sel_w, taps = _resample_band(self.uvs, self.weights)
        self._sel, self._sel_w = dev(sel), dev(sel_w)
        self._taps = [(dev(i), dev(w)) for i, w in taps]
        dst, src = _copy_band(self.dst_ij, self.src_ij, W)
        self._dst, self._src = dev(dst), dev(src)

    def _flat(self, value: torch.Tensor) -> torch.Tensor:
        B, C, H, W = value.shape
        if (H, W) != self._hw:
            raise ValueError(f"SeamSampler built for {self._hw}, got "
                             f"{(H, W)}")
        return value.reshape(B, C, H * W)

    def impaint(self, value: torch.Tensor) -> torch.Tensor:
        return _impaint_flat(self._flat(value), self._dst,
                             self._src).reshape(value.shape)

    def resample(self, tex: torch.Tensor) -> torch.Tensor:
        return _resample_flat(self._flat(tex), self._sel, self._sel_w,
                              self._taps).reshape(tex.shape)

    def resample_border_only(self, tex: torch.Tensor) -> torch.Tensor:
        return self.resample(tex)

    def __call__(self, tex: torch.Tensor) -> torch.Tensor:
        return self.resample(self.impaint(tex))
