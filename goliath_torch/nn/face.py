"""Frozen frontal face decoder (port of the JAX package's nn/face.py).

Decodes an external 256-d face latent into face geometry [B, n_vert_out/3,
3] and a frontal texture at ``tex_out_shp`` (1024^2 by default). The
weights are meant to come from a pretrained checkpoint; the drivable
mesh-VAE (``models/mesh_vae_drivable.py``) takes its outputs without a
gradient. Submodules carry the flax names (``encmod``, ``geommod``,
``viewmod``, ``texfc``, ``texmod_up{i}``, ``texmod_out``, ``bias``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from goliath_torch.nn.layers import ConvTranspose2dWNUB, LinearWN, leaky_relu


def up_widths(out_size: int) -> list:
    """The widths of the up-convolutions before ``texmod_out``, as the JAX
    module computes them: at 1024 the reference's 256, 128, 128, 64, 64,
    32, 8 (sizes 8 to 512); at smaller sizes the tail of that list with
    its first width set to 256."""
    full = [256, 256, 128, 128, 64, 64, 32, 8]
    n_ups = int(math.log2(out_size // 4))
    widths = full[-(n_ups - 1):] if n_ups > 1 else []
    return [256] + list(widths[1:]) if len(widths) else []


class FaceDecoderFrontal(nn.Module):
    """face_embs [B, n_latent] -> ``face_geom`` [B, n_vert_out / 3, 3],
    ``face_tex_raw`` [B, 3, H, W] and ``face_tex`` = 255 (raw + bias +
    0.5), the view being ``assets.face_frontal_view`` for every sample."""

    def __init__(self, assets: Any, n_latent: int = 256,
                 n_vert_out: int = 3 * 7306,
                 tex_out_shp: Sequence[int] = (1024, 1024),
                 tex_roi: Optional[Any] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.register_buffer("frontal_view", torch.from_numpy(np.array(
            assets.face_frontal_view, np.float32)), persistent=False)
        self.encmod = LinearWN(n_latent, 256, generator=g)
        self.geommod = LinearWN(256, n_vert_out, generator=g)
        self.viewmod = LinearWN(3, 8, generator=g)
        self.texfc = LinearWN(256 + 8, 256 * 4 * 4, generator=g)
        out_size = int(tex_out_shp[0])
        size, cin = 4, 256
        self.n_ups = 0
        for i, w in enumerate(up_widths(out_size)):
            size *= 2
            self.add_module(f"texmod_up{i}", ConvTranspose2dWNUB(
                cin, w, size, size, 4, 2, 1, generator=g))
            cin = w
            self.n_ups += 1
        self.texmod_out = ConvTranspose2dWNUB(cin, 3, out_size, out_size, 4,
                                              2, 1, alpha=1.0, generator=g)
        roi = tex_roi or ((0, 0), tuple(tex_out_shp))
        roi_h = roi[1][0] - roi[0][0]
        roi_w = roi[1][1] - roi[0][1]
        self.bias = nn.Parameter(torch.zeros(3, roi_h, roi_w))

    def forward(self, face_embs: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = face_embs.shape[0]
        view = self.frontal_view[None].expand((B,) + self.frontal_view.shape)
        encout = leaky_relu(self.encmod(face_embs))
        geomout = self.geommod(encout)
        viewout = leaky_relu(self.viewmod(view))
        h = leaky_relu(self.texfc(torch.cat([encout, viewout], dim=1)))
        h = h.reshape(-1, 256, 4, 4)
        for i in range(self.n_ups):
            h = leaky_relu(getattr(self, f"texmod_up{i}")(h))
        texout = self.texmod_out(h)
        return {
            "face_geom": geomout.reshape(B, -1, 3),
            "face_tex_raw": texout,
            "face_tex": 255 * (texout + self.bias[None] + 0.5),
        }
