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
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device


class SeamSampler:
    def __init__(self, seamless_data: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda") -> None:
        device = resolve_device(device)
        self.dst_ij = np.asarray(seamless_data["dst_ij"], np.int64)
        self.src_ij = np.asarray(seamless_data["src_ij"], np.int64)
        self.uvs = np.asarray(seamless_data["uvs"], np.float32)
        self.weights = np.asarray(seamless_data["weights"], np.float32)
        w = self.weights
        w2d = w.reshape(w.shape[-3:]) if w.ndim >= 3 else w[None]
        _, H, W = w2d.shape
        self._hw = (H, W)

        def dev(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        # resample: the texels with a non-zero weight and their 4 taps of
        # grid_sample(align_corners=False, padding_mode='border')
        nz = np.nonzero(np.abs(w2d).max(axis=0) > 0)
        if nz[0].size == 0:
            nz = (np.zeros(1, np.int64), np.zeros(1, np.int64))
        self._sel = dev(nz[0] * W + nz[1])                         # [K]
        self._sel_w = dev(w2d[:, nz[0], nz[1]].astype(np.float32))  # [Cw, K]
        uv = self.uvs[nz[0], nz[1]]                                # [K, 2]
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
                taps.append((dev(yi * W + xi), dev(tw.astype(np.float32))))
        self._taps = taps

        # impaint: dst <- src copies, dst deduplicated keeping the LAST
        # occurrence (scatter-set semantics)
        dst = self.dst_ij[:, 0] * W + self.dst_ij[:, 1]
        src = self.src_ij[:, 0] * W + self.src_ij[:, 1]
        _, last = np.unique(dst[::-1], return_index=True)
        keep = np.sort(dst.size - 1 - last)
        self._dst, self._src = dev(dst[keep]), dev(src[keep])

    def _flat(self, value: torch.Tensor) -> torch.Tensor:
        B, C, H, W = value.shape
        if (H, W) != self._hw:
            raise ValueError(f"SeamSampler built for {self._hw}, got "
                             f"{(H, W)}")
        return value.reshape(B, C, H * W)

    def impaint(self, value: torch.Tensor) -> torch.Tensor:
        xf = self._flat(value)
        delta = xf[..., self._src] - xf[..., self._dst]
        return xf.index_add(-1, self._dst, delta).reshape(value.shape)

    def resample(self, tex: torch.Tensor) -> torch.Tensor:
        xf = self._flat(tex)
        cur = xf[..., self._sel]
        res = None
        for idx, w in self._taps:
            term = xf[..., idx] * w
            res = term if res is None else res + term
        delta = self._sel_w[None] * (res - cur)
        return xf.index_add(-1, self._sel, delta).reshape(tex.shape)

    def resample_border_only(self, tex: torch.Tensor) -> torch.Tensor:
        return self.resample(tex)

    def __call__(self, tex: torch.Tensor) -> torch.Tensor:
        return self.resample(self.impaint(tex))
