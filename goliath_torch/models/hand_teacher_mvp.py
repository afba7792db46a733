"""OLAT relighting teacher for MVP hands (port of the JAX package's
models/hand_teacher_mvp.py; reference ca_code/models/hand_teacher_mvp.py).

The hand_mvp net with its geometry path (poseencoder + geomdecoder) run
with ``train=False`` and detached, and, in place of its RGB slab decoder, a
second PoseEncoder and an OLATRGBDecoder: per-(prim, voxel) deep shadows
from each light (``ops/mvp.splat_density_grid`` + ``shadow_at_points``, or
``shadow_at_points_exact``), light and view directions in the prims'
frames, and a UNet over (lightvec, viewdir, 1 - shadow) slabs a light that
gives each light's RGBA slab. The relit slab is sum_lights
sigmoid(shadow_pred) * relu(olat_tex) * intensity; the raymarcher renders
it as hand_mvp's.

Submodules carry the flax names (``poseencoder2``,
``relightdecoder.unet.enc0`` .. ``dec4``), so
``goliath_torch.convert.params_from_jax`` maps the JAX parameters one to
one; the net has no ``rgbdecoder``. The shadows are computed without
gradient, where the JAX package has ``stop_gradient``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from goliath_torch.models import hand_mvp as base
from goliath_torch.nn.layers import Conv2dWNUB, leaky_relu
from goliath_torch.ops.mvp import (shadow_at_points, shadow_at_points_exact,
                                   splat_density_grid)
from goliath_torch.utils.image import relu
from goliath_torch.utils.sampling import interpolate_bilinear, linspace

SHADOW_MODES = ("grid", "exact")


class _OLATUNet(nn.Module):
    """The OLAT decoder's UNet over (lightvec, viewdir, 1 - shadow) slabs
    (reference hand_teacher_mvp.py:434-492): a ladder of
    bilinear-resampled (align_corners) Conv2dWNUB + leaky_relu, the joint
    features joined at the bottleneck."""

    def __init__(self, uv_size: int, pz: int, n_enc_dims: Tuple[int, ...],
                 n_joint_feats: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = list(n_enc_dims)
        self.sizes = [uv_size // (2 ** i) for i in range(len(d))]
        enc_dims = [((2 * 3 + 1) * pz, d[0])] + [(d[i - 1], d[i])
                                                 for i in range(1, len(d))]
        dec_dims = [(d[-1] + n_joint_feats, d[-2])]
        for i in range(1, len(d) - 1):
            dec_dims.append((d[len(d) - 1 - i] * 2, d[len(d) - 2 - i]))
        dec_dims.append((d[0] * 2, pz * 4))
        for i, size in enumerate(self.sizes):
            self.add_module(f"enc{i}", Conv2dWNUB(
                *enc_dims[i], size, size, 3, 1, 1, generator=generator))
        for i, size in enumerate(reversed(self.sizes)):
            self.add_module(f"dec{i}", Conv2dWNUB(
                *dec_dims[i], size, size, 3, 1, 1, generator=generator))

    def forward(self, x: torch.Tensor, jf: torch.Tensor) -> torch.Tensor:
        n = len(self.sizes)
        enc_acts = []
        for i, size in enumerate(self.sizes):
            x = leaky_relu(getattr(self, f"enc{i}")(x), 0.2)
            enc_acts.append(x)
            if i < n - 1:
                x = interpolate_bilinear(x, size=(size // 2, size // 2),
                                         align_corners=True)
        for i in range(n):
            if i == 0:
                skip = interpolate_bilinear(jf, size=tuple(x.shape[2:]),
                                            align_corners=True)
                x = torch.cat([x, skip], 1)
            else:
                skip = enc_acts[-i - 1]
                x = torch.cat([interpolate_bilinear(
                    x, size=tuple(skip.shape[2:]), align_corners=True),
                    skip], 1)
            x = leaky_relu(getattr(self, f"dec{i}")(x), 0.2)
        return x


class OLATRGBDecoder(nn.Module):
    """Per-light OLAT texture decoder (reference hand_teacher_mvp.py:159-554).
    ``shadow_mode`` "grid" (the global density grid) or "exact" (the
    per-prim oracle, O(K^2 V S): parity studies only)."""

    def __init__(self, uv_size: int, primsize: Tuple[int, int, int],
                 n_prim_x: int, n_prim_y: int, volradius: float,
                 n_joint_feats: int,
                 n_enc_dims: Tuple[int, ...] = (64, 64, 64, 64, 64),
                 shadow_grid_res: int = 64, shadow_steps: int = 32,
                 shadow_mode: str = "grid",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.uv_size, self.primsize = uv_size, tuple(primsize)
        self.n_prim_x, self.n_prim_y = n_prim_x, n_prim_y
        self.volradius = volradius
        self.shadow_grid_res, self.shadow_steps = shadow_grid_res, shadow_steps
        self.shadow_mode = shadow_mode
        self.unet = _OLATUNet(uv_size, self.primsize[2], tuple(n_enc_dims),
                              n_joint_feats, generator=generator)

    def voxel_centres(self, device) -> torch.Tensor:
        """The prims' voxel centres in prim coordinates, [Z*Y*X, 3] (x, y,
        z), z-major (reference :383-402)."""
        pz, py, px = self.primsize[2], self.primsize[1], self.primsize[0]
        zz, yy, xx = torch.meshgrid(linspace(-1.0, 1.0, pz, device),
                                    linspace(-1.0, 1.0, py, device),
                                    linspace(-1.0, 1.0, px, device),
                                    indexing="ij")
        return torch.stack([xx, yy, zz], -1).reshape(-1, 3)

    @torch.no_grad()
    def shadows(self, primpos, primrot, primscale, pa, points, light_pos):
        """1 - transmittance from each light to each voxel centre,
        [B, L, K * V], in the normalized volume frame."""
        if self.shadow_mode not in SHADOW_MODES:
            raise ValueError(f"shadow_mode {self.shadow_mode!r} is not one "
                             f"of {SHADOW_MODES}")
        vr = self.volradius
        out = []
        for b in range(primpos.shape[0]):
            pp = primpos[b] / vr
            pts = points[b].reshape(-1, 3) / vr
            if self.shadow_mode == "exact":
                out.append(torch.stack([shadow_at_points_exact(
                    pp, primrot[b], primscale[b], pa[b], pts, lp / vr,
                    self.shadow_steps) for lp in light_pos[b]]))
                continue
            density = splat_density_grid(pp, primrot[b], primscale[b], pa[b],
                                         self.shadow_grid_res)
            out.append(torch.stack([shadow_at_points(
                density, pts, lp / vr, self.shadow_steps)
                for lp in light_pos[b]]))
        return torch.stack(out)

    def forward(
        self,
        campos: torch.Tensor,          # [B, 3]
        primpos: torch.Tensor,         # [B, K, 3] world
        primrot: torch.Tensor,         # [B, K, 3, 3]
        primscale: torch.Tensor,       # [B, K, 3]
        primalpha: torch.Tensor,       # [B, Z, 1, uv, uv]
        valid_prims: torch.Tensor,     # [K] float 0 / 1
        joint_feat: torch.Tensor,      # [B, C, n_prim_x, n_prim_y]
        light_pos: torch.Tensor,       # [B, L, 3]
        light_intensity: torch.Tensor,  # [B, L, 1]
        iteration=None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        B, L = light_pos.shape[:2]
        pz, py, px = self.primsize[2], self.primsize[1], self.primsize[0]
        npx, npy = self.n_prim_x, self.n_prim_y
        K = npx * npy
        S = self.uv_size
        vr = self.volradius

        # slab -> per-prim voxel alphas [B, K, Z, Y, X]
        pa = primalpha.reshape(B, pz, 1, npy, py, npx, px)
        pa = pa.permute(0, 3, 5, 1, 4, 6, 2)[..., 0].reshape(B, K, pz, py, px)
        pa = pa * valid_prims[None, :, None, None, None]

        # the prims' voxel centres in world: primpos + vr * R (y / scale)
        y_local = self.voxel_centres(primpos.device)                 # [V, 3]
        prims = primpos[:, :, None] + vr * torch.einsum(
            "bkij,bkvj->bkvi", primrot,
            y_local[None, None] / primscale[:, :, None])         # [B,K,V,3]

        shadow = self.shadows(primpos, primrot, primscale, pa, prims,
                              light_pos)
        # shadow -> slab layout [B*L, Z, uv, uv] (reference :360-377)
        shadow = shadow.reshape(B, L, npy, npx, 1, pz, py, px)
        shadow = shadow.permute(0, 1, 5, 4, 2, 6, 3, 7).reshape(
            B * L, pz, S, S)

        # light and view directions in the prims' frames (reference
        # :404-432)
        lightvec = light_pos[:, :, None, None] - prims[:, None]  # [B,L,K,V,3]
        lightvec = lightvec / torch.sqrt(
            (lightvec ** 2).sum(-1, keepdim=True) + 1e-12)
        viewdir = campos[:, None, None] - prims                   # [B,K,V,3]
        viewdir = viewdir / torch.sqrt(
            (viewdir ** 2).sum(-1, keepdim=True) + 1e-12)
        del prims
        lightvec = torch.einsum("bkef,blkve->blkvf", primrot, lightvec)
        viewdir = torch.einsum("bkef,bkve->bkvf", primrot, viewdir)
        vp = valid_prims[None, :, None, None]
        viewdir = viewdir * vp
        lightvec = lightvec * vp[:, None]

        def to_slab(x, lead):   # [lead, K, V, 3] -> [lead, Z*3, S, S]
            x = x.reshape(lead, npy, npx, pz, py, px, 3)
            return x.permute(0, 3, 6, 1, 4, 2, 5).reshape(lead, pz * 3, S, S)

        lightvec = to_slab(lightvec.reshape(B * L, K, -1, 3), B * L)
        viewdir = to_slab(viewdir, B)
        viewdir = viewdir[:, None].expand(B, L, -1, S, S).reshape(
            B * L, -1, S, S)
        x = torch.cat([lightvec, viewdir, 1.0 - shadow], 1)
        del lightvec, viewdir
        jf = joint_feat[:, None].expand(B, L, *joint_feat.shape[1:]).reshape(
            B * L, *joint_feat.shape[1:])

        # the UNet's activations at uv 1024 over B*L slabs are recomputed
        # in the backward, as the JAX package's nn.remat does
        if torch.is_grad_enabled():
            tex = checkpoint(self.unet, x, jf, use_reentrant=False)
        else:
            tex = self.unet(x, jf)
        del x
        tex = tex.reshape(B, L, pz, 4, S, S)

        shadowolat = torch.sigmoid(tex[:, :, :, :1])
        if train and iteration is not None:
            warm = torch.as_tensor(iteration, device=tex.device) < 1000
            shadowolat = torch.where(warm, shadow.reshape(B, L, pz, 1, S, S),
                                     shadowolat)
        texolat = 25.0 * tex[:, :, :, 1:] + 100.0

        li = light_intensity[:, :, None, :, None, None]
        rgb = (shadowolat * relu(texolat) * li).sum(1)
        rgb = rgb.reshape(B, pz, 3, S, S)

        primshadow = shadow[:, :, None].expand(B * L, pz, 3, S, S).reshape(
            B, L, pz, 3, S, S).sum(1) / L

        out = {"primrgb": rgb, "primshadow": primshadow}
        if train:
            out["texolat"] = texolat
        return out


class _HandTeacherNet(base._HandMVPNet):
    """The hand_mvp net with the OLAT relight path in place of its RGB
    slab decoder."""

    def build_appearance(self, n_pose_dims: int, n_embs: int,
                         generator: Optional[torch.Generator]) -> None:
        self.poseencoder2 = base.PoseEncoder(n_pose_dims, n_embs,
                                             self.n_prim_x,
                                             generator=generator)
        self.relightdecoder = OLATRGBDecoder(
            self.uv_size, self.primsize, self.n_prim_x, self.n_prim_y,
            self.volradius, n_embs, generator=generator)

    def forward(
        self,
        pose: torch.Tensor,
        campos: torch.Tensor,
        light_intensity: Optional[torch.Tensor] = None,
        light_pos: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        Rt: Optional[torch.Tensor] = None,
        camera_idx: Optional[torch.Tensor] = None,
        background: Optional[torch.Tensor] = None,
        iteration: Optional[torch.Tensor] = None,
        train: bool = False,
    ) -> Dict[str, Any]:
        joint = self.poseencoder(pose)
        # the geometry path is frozen: evaluated as at eval and detached
        geo_preds = {k: v.detach() for k, v in self.geomdecoder(
            pose, joint, iteration, False).items()}
        dec_preds = self.relightdecoder(
            campos, geo_preds["primpos"], geo_preds["primrot"],
            geo_preds["primscale"], geo_preds["primalpha"], self.valid_prims,
            self.poseencoder2(pose), light_pos, light_intensity, iteration,
            train)
        preds: Dict[str, Any] = {"primrgb": dec_preds["primrgb"],
                                 **geo_preds, **dec_preds}
        return self.render(preds, K, Rt, camera_idx, background, train)


class AutoEncoder(base.AutoEncoder):
    """The hand_mvp facade (its tables, skeleton and raymarcher) with the
    teacher net; ``shadow_mode`` as OLATRGBDecoder's."""

    net_class = _HandTeacherNet

    def __init__(self, *args, shadow_mode: str = "grid", **kwargs):
        super().__init__(*args, **kwargs)
        self.module.relightdecoder.shadow_mode = shadow_mode


HandMVPSummary = base.HandMVPSummary
