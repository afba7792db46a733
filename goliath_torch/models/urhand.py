"""URHand, the universal relightable hand (port of the JAX package's
models/urhand.py).

Physics-inspired and neural on a mesh: LBS poses the template; per-texel
TBN frames come from UV-edge weights precomputed once; raster shadow maps
are rendered from each of the B x L lights (``utils/shadowmap.py``: one
z-buffer launch, K5, a light view, its binning on K4) and soft-compared;
hand-crafted lambert and phong features feed a DisplacementUNet that
refines the geometry along the normals and predicts roughness; a second
shadow pass runs on the displaced geometry; full GGX with Schlick fresnel
drives a "phys" branch (albedo / pi + GGX) and a "linear" branch in which
a FeatEncoderUNet encodes the light features into gain/bias side outputs
for two conv stacks with gain-bias modulation. The texture tex_mean * gain
+ bias * 64 is seam-resampled and rendered (rgb, phys and normals) with
the mesh rasterizer.

Submodules and parameters carry the flax names (``decoder_relight``,
``geo_refiner.enc0``, ``featenc.gb0``, ``texmod1_3``, ...), so
``goliath_torch.convert.params_from_jax`` maps the JAX parameters one to
one. ``.detach()`` stands where the JAX package has ``stop_gradient``.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from goliath_torch.models.base import ModelFacade
from goliath_torch.models.mesh_vae import _buffer, _identity_seam_data
from goliath_torch.nn.blocks import ConvBlock, tile2d
from goliath_torch.nn.color_cal import CalV5
from goliath_torch.nn.layers import Conv2dWN, Conv2dWNUB, leaky_relu
from goliath_torch.ops.backend import resolve_device
from goliath_torch.ops.rasterizer import RenderLayer
from goliath_torch.utils.geom import (
    GeometryModule,
    _normalize,
    make_uv_vert_index,
    vert_normals,
    xyz2normals,
)
from goliath_torch.utils.image import clip
from goliath_torch.utils.lbs import LBSModule
from goliath_torch.utils.quaternion import (
    matrix_to_axisangle,
    quat_from_xyz,
    quat_to_matrix,
)
from goliath_torch.utils.sampling import interpolate_bilinear
from goliath_torch.utils.seams import SeamSampler
from goliath_torch.utils.shadowmap import get_shadow_map

logger = logging.getLogger(__name__)


def _norm_cf(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / max(|x|, eps) along dim 1, the JAX package's value bit for bit.
    Its gradient is the JAX package's wherever that is finite, and that of
    x / eps at a zero vector, where the JAX package's is NaN (the norm's
    path adds 0 * inf: the sqrt's derivative at 0 times the clip's zero):
    the sum of squares is clamped at float32's smallest normal before the
    sqrt, which changes no value (its sqrt is far below eps). Such vectors
    occur where a normal is exactly zero: the synthetic sphere's poles
    repeat one point along a texel row."""
    ss = torch.sum(x * x, dim=1, keepdim=True).clamp(
        min=torch.finfo(x.dtype).tiny)
    return x / torch.sqrt(ss).clamp(min=eps)


def _cross_cf(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
         u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
         u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def build_cam_rot_mat(campos: torch.Tensor, objcenter: torch.Tensor
                      ) -> torch.Tensor:
    """Look-at rotation rows [N, 3, 3] of cameras at campos [N, 3] looking
    at objcenter [N, 3], y up (a camera straight above or below is moved by
    1e-2 in z)."""
    degenerate = (campos[:, 0].abs() + campos[:, 2].abs()) < 1e-8
    campos = campos.clone()
    campos[:, 2] = campos[:, 2] + torch.where(degenerate, 1e-2, 0.0)
    z = _normalize(objcenter - campos)
    up = torch.zeros_like(campos)
    up[:, 1] = 1.0
    x = _normalize(torch.linalg.cross(z, up))
    y = _normalize(torch.linalg.cross(z, x))
    return torch.stack([x, y, z], dim=1)


class FeatEncoderUNet(nn.Module):
    """Light-feature encoder with gain/bias side outputs."""

    def __init__(self, n_diff_feat: int, n_spec_feat: int, out_ch: int,
                 m: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        c = 3
        nfc = [64, 64 * c, 128 * c, 128 * c, 256 * c]
        nbc = [64, 64 * m, 128 * m, 128 * m, 256 * m]
        self.proj = Conv2dWN(n_diff_feat + n_spec_feat, 64, 7, 1, 3,
                             use_bias=False, generator=g)
        self.n_levels = len(nfc) - 1
        for i in range(self.n_levels):
            self.add_module(f"feat{i}", Conv2dWN(
                nfc[i], nfc[i + 1], 4, 2, 1, use_bias=False, generator=g))
            self.add_module(f"gb{i}", Conv2dWN(
                nfc[i + 1], nbc[i + 1], 1, 1, 0, use_bias=False,
                generator=g))
        self.enc = Conv2dWN(256 * c, out_ch, 4, 2, 1, generator=g)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.proj(x)
        gb: List[torch.Tensor] = []
        for i in range(self.n_levels):
            x = getattr(self, f"feat{i}")(x)
            gb.insert(0, getattr(self, f"gb{i}")(x))
        return self.enc(x), gb


class DisplacementUNet(nn.Module):
    """Geometry refinement (a displacement along the normal) and roughness
    UNet: one encoder, two decoders."""

    def __init__(self, uv_size: int, init_uv_size: int, output_scale: float,
                 pose_feat_dim: int,
                 n_enc_dims: Tuple[int, ...] = (64, 64, 64, 64, 64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.output_scale = output_scale
        n_blocks = int(math.log2(uv_size // init_uv_size))
        self.sizes = [init_uv_size * 2**s for s in range(n_blocks + 1)]
        d = list(n_enc_dims)[: n_blocks + 1]
        enc_dims = [(6, d[0])] + [(d[i - 1], d[i]) for i in range(1, len(d))]
        dec_dims = [(d[-1] + pose_feat_dim, d[-2] if len(d) > 1 else 1)]
        for i in range(1, len(d)):
            cout = d[len(d) - 2 - i] if len(d) - 2 - i >= 0 else 1
            dec_dims.append((d[len(d) - 1 - i] * 2, cout))
        dec_dims[-1] = (dec_dims[-1][0], 1)
        rough_dims = [(d[-1], dec_dims[0][1])] + dec_dims[1:]
        n = len(self.sizes)
        for i in range(n):
            size = self.sizes[-i - 1]
            self.add_module(f"enc{i}", Conv2dWNUB(
                *enc_dims[i], size, size, 3, 1, 1, generator=g))
        for prefix, dims in (("dec", dec_dims), ("rough", rough_dims)):
            for i, size in enumerate(self.sizes):
                alpha = 1.0 if i == n - 1 else 0.2
                self.add_module(f"{prefix}{i}", Conv2dWNUB(
                    *dims[i], size, size, 3, 1, 1, alpha=alpha, generator=g))

    def _decode(self, x: torch.Tensor, enc_acts: List[torch.Tensor],
                prefix: str, cond: Optional[torch.Tensor] = None):
        interm = None
        for i in range(len(self.sizes)):
            if i == 0:
                if cond is not None:
                    x = torch.cat([x, cond], dim=1)
                    interm = x
            else:
                x = leaky_relu(x, 0.2)
                x_prev = enc_acts[-i - 1]
                x = interpolate_bilinear(x, size=tuple(x_prev.shape[2:4]),
                                         align_corners=True)
                x = torch.cat([x, x_prev], dim=1)
            x = getattr(self, f"{prefix}{i}")(x)
        return torch.tanh(x), interm

    def forward(self, feat_uv: torch.Tensor, pose_cond: torch.Tensor):
        enc_acts = []
        x = feat_uv
        n = len(self.sizes)
        for i in range(n):
            size = self.sizes[-i - 1]
            x = leaky_relu(getattr(self, f"enc{i}")(x), 0.2)
            enc_acts.append(x)
            if i < n - 1:
                x = interpolate_bilinear(x, size=(size // 2, size // 2),
                                         align_corners=True)
        disp, interm_feat = self._decode(x, enc_acts, "dec", cond=pose_cond)
        disp = disp * self.output_scale
        rough, _ = self._decode(x, enc_acts, "rough")
        roughness = (rough + 1.0) / 4.0 + 0.3  # [0.3, 0.8]
        return disp, roughness, interm_feat


class ConvTeacherDecoder(nn.Module):
    """Relightable teacher decoder. What the JAX decoder rebuilds from numpy
    on every call (the UV mask, the UV-edge tangent weights, the three
    corner index images, the raw index mask) is built once here, on the
    module's buffers."""

    def __init__(self, geo_fn: GeometryModule, raw_index_mask: Any,
                 uv_size: int, init_uv_size: int, pose_enc_dims: int,
                 disp_enc_dims: Tuple[int, ...], disp_scale: float,
                 shadow_rl: RenderLayer, init_channels: int = 128,
                 min_channels: int = 16, refine_geo: bool = True,
                 feat_uv: str = "texmean", view_cond: bool = True,
                 fresnel: float = 0.04, scaled_albedo: bool = True,
                 shadow: bool = True,
                 spec_powers: Tuple[int, ...] = (1, 16, 32),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.geo_fn, self.shadow_rl = geo_fn, shadow_rl
        self.uv_size, self.init_uv_size = uv_size, init_uv_size
        self.refine_geo, self.feat_uv = refine_geo, feat_uv
        self.view_cond, self.fresnel = view_cond, fresnel
        self.scaled_albedo, self.shadow = scaled_albedo, shadow
        self.spec_powers = tuple(spec_powers)

        index_image = geo_fn.index_image_np
        _buffer(self, "mask", np.all(index_image != -1, axis=-1))
        # UV-edge tangent weights: the tangent is e1 * w_e1 - e2 * w_e2 of
        # the texel's face edges, in the JAX package's float32 numpy
        idx_np = np.clip(index_image, 0, None)               # [S, S, 3]
        v2uv = geo_fn.v2uv.cpu().numpy()
        tri_uv = geo_fn.vt_np[v2uv[idx_np, 0]]               # [S, S, 3, 2]
        vt01 = tri_uv[..., 1, :] - tri_uv[..., 0, :]
        vt02 = tri_uv[..., 2, :] - tri_uv[..., 0, :]
        fin = vt01[..., 0] * vt02[..., 1] - vt01[..., 1] * vt02[..., 0]
        fin = np.where(np.abs(fin) < 1e-8, 1e-8, fin)
        _buffer(self, "w_e1", vt02[..., 1] / fin)
        _buffer(self, "w_e2", vt01[..., 1] / fin)
        self.register_buffer(
            "corners", torch.from_numpy(np.ascontiguousarray(
                idx_np.transpose(2, 0, 1))), persistent=False)  # [3, S, S]
        _buffer(self, "raw_index_mask",
                np.asarray(raw_index_mask, np.float32)[None, None])

        disp_enc_dims = tuple(disp_enc_dims)
        self.geo_refiner = DisplacementUNet(
            uv_size, init_uv_size, disp_scale, pose_enc_dims, disp_enc_dims,
            generator=g)
        d = list(disp_enc_dims)[: len(self.geo_refiner.sizes)]
        n_joint = d[-1] + pose_enc_dims + (3 if view_cond else 0)
        self.joint_conv_block_tex = ConvBlock(n_joint, init_channels,
                                              init_uv_size, generator=g)
        self.featenc = FeatEncoderUNet(1, len(self.spec_powers), 128,
                                       generator=g)
        nc = [128, 256, 128, 128, 64, 32, 16, 4]
        n_layers = int(math.log2((uv_size * 4) // init_uv_size)) + 1
        self.n_layers = min(n_layers, len(nc) - 1)
        hh = init_uv_size
        for i in range(self.n_layers):
            alpha = 1.0 if i == self.n_layers - 1 else 0.2
            cin = init_channels if i == 0 else nc[i]
            self.add_module(f"texmod0_{i}", Conv2dWNUB(
                cin, nc[i + 1], hh, hh, 3, 1, 1, alpha=alpha, generator=g))
            self.add_module(f"texmod1_{i}", Conv2dWN(
                128 if i == 0 else nc[i], nc[i + 1], 3, 1, 1,
                use_bias=False, alpha=alpha, generator=g))
            hh *= 2
        self.global_albedo_scale = nn.Parameter(torch.zeros(1))
        self.global_scale = nn.Parameter(torch.ones(1))

    def tbn_uv(self, verts: torch.Tensor, normals_cf: torch.Tensor):
        """Per-texel TBN, channel-first: (t, b, n) [B, 3, S, S]."""
        vt_cf = verts.transpose(1, 2)                       # [B, 3, V]
        i0, i1, i2 = self.corners
        c0 = vt_cf[:, :, i0]                                # [B, 3, S, S]
        tang = ((vt_cf[:, :, i1] - c0) * self.w_e1[None, None]
                - (vt_cf[:, :, i2] - c0) * self.w_e2[None, None])
        tang = _norm_cf(tang)
        n = normals_cf
        bt = _norm_cf(_cross_cf(n, tang))
        tang = _norm_cf(_cross_cf(bt, n))
        m = self.mask[None, None]
        return tang * m, bt * m, n * m

    def shadow_pass(self, verts: torch.Tensor, p_uv: torch.Tensor,
                    nml: torch.Tensor, light_pos: torch.Tensor
                    ) -> torch.Tensor:
        """exp(-shadow / 8) [B, L, 1, S, S] from the B x L light views."""
        B, L = light_pos.shape[:2]
        S = self.uv_size
        posc = (verts.amax(1) + verts.amin(1)) / 2
        posc = posc[:, None].expand(B, L, 3).reshape(-1, 3)
        lightpos = light_pos.reshape(-1, 3)
        lightrot = build_cam_rot_mat(lightpos, posc)
        Rt_l = torch.cat([lightrot, -torch.einsum(
            "bij,bj->bi", lightrot, lightpos)[..., None]], dim=2)

        def rep(x):
            return x[:, None].expand((B, L) + x.shape[1:]).reshape(
                (B * L,) + x.shape[1:])

        sm = get_shadow_map(self.shadow_rl, Rt_l, None, rep(verts),
                            rep(p_uv), rep(nml))
        sm = torch.exp(-sm / 8.0)
        return sm.reshape(B, L, 1, S, S).detach()

    def forward(self, lbs_motion: torch.Tensor, id_mesh: torch.Tensor,
                tex_mean: torch.Tensor, verts_rec: torch.Tensor,
                cam_pos: torch.Tensor, light_pos: torch.Tensor,
                light_intensity: torch.Tensor, train: bool = False
                ) -> Dict[str, Any]:
        S = self.uv_size
        gf = self.geo_fn

        vert_nml = vert_normals(verts_rec, gf.vi)
        n0 = _norm_cf(gf.to_uv(vert_nml))                    # [B, 3, S, S]
        tbn_t, tbn_b, tbn_n = self.tbn_uv(verts_rec, n0)

        p_uv = gf.to_uv(verts_rec)                           # [B, 3, S, S]
        v_uv = _normalize(cam_pos[..., None, None] - p_uv, dim=1)
        li = light_intensity[..., None, None]                # [B, L, 1, 1, 1]

        nml = tbn_n
        if self.shadow:
            shadow_map = self.shadow_pass(verts_rec, p_uv, nml, light_pos)

        # lambert + phong features
        l_uv = _normalize(light_pos[..., None, None] - p_uv[:, None], dim=2)
        view = -v_uv
        ref = view - 2.0 * torch.sum(view * nml, 1, keepdim=True) * nml
        diff = torch.sum(nml[:, None] * l_uv, 2, keepdim=True).clamp(0.0, 1.0)
        spec0 = torch.sum(ref[:, None] * l_uv, 2, keepdim=True).clamp(min=0.0)
        spec = torch.stack([(spec0**p).clamp(max=1.0)
                            for p in self.spec_powers], 2)
        if self.shadow:
            diff_p = torch.sum(diff * li * shadow_map, 1)
            spec_p = torch.sum(spec * li[:, :, None]
                               * shadow_map[:, :, None], 1)
        else:
            diff_p = torch.sum(diff * li, 1)
            spec_p = torch.sum(spec * li[:, :, None], 1)
        lint_scale = torch.sum(li, 1)
        inv_lint = 1.0 / (lint_scale + 1e-6)

        outputs: Dict[str, Any] = {
            "diff_feature_raw": inv_lint * diff_p,
            "spec_feature_raw": inv_lint[:, None] * spec_p,
            "feature_normal_raw": nml,
        }
        if self.shadow:
            outputs["shadow_raw"] = shadow_map

        # displacement and roughness
        uv_id_mesh = gf.to_uv(id_mesh)
        pose_cond = tile2d(lbs_motion, self.init_uv_size)
        normalized_tex = (tex_mean / 255.0) * 2.0 - 1.0
        uv_id_mesh = uv_id_mesh * self.raw_index_mask
        normalized_tex = normalized_tex * self.raw_index_mask
        if self.feat_uv == "texmean":
            uv_refiner_feat = torch.cat([normalized_tex, normalized_tex], 1)
        elif self.feat_uv == "texmean_geo":
            uv_refiner_feat = torch.cat([normalized_tex, uv_id_mesh], 1)
        else:  # "geo"
            uv_refiner_feat = torch.cat([uv_id_mesh, nml], 1)
        displacement, roughness, id_pose_feat = self.geo_refiner(
            uv_refiner_feat, pose_cond)
        if not self.refine_geo:
            displacement = displacement * 0.0

        p_uv_displaced = p_uv + nml.detach() * displacement
        n_disp = xyz2normals(p_uv_displaced)
        verts_rec_displaced = gf.from_uv(p_uv_displaced)
        tbn_t, tbn_b, tbn_n = self.tbn_uv(verts_rec_displaced, n_disp)
        tbn_n = -tbn_n  # the reference flips the normal after displacement

        p_uv = p_uv_displaced
        v_uv = _normalize(cam_pos[..., None, None] - p_uv, dim=1)
        nml = tbn_n
        if self.shadow:
            shadow_map = self.shadow_pass(verts_rec_displaced.detach(),
                                          p_uv.detach(), nml, light_pos)

        # GGX specular and the phys branch
        ggx_L = _normalize(light_pos[..., None, None] - p_uv[:, None], dim=2)
        ggx_V = v_uv
        ggx_H = _normalize((ggx_L + ggx_V[:, None]) / 2.0, dim=2)
        ggx_N = nml
        nov0 = torch.sum(ggx_V * ggx_N, 1, keepdim=True)
        ggx_N = ggx_N * torch.sign(nov0)
        nol = torch.sum(ggx_N[:, None] * ggx_L, 2, keepdim=True).clamp(
            1e-6, 1.0)
        nov = torch.sum(ggx_N * ggx_V, 1, keepdim=True)
        noh = torch.sum(ggx_N[:, None] * ggx_H, 2, keepdim=True).clamp(
            1e-6, 1.0)
        voh = torch.sum(ggx_V[:, None] * ggx_H, 2, keepdim=True).clamp(
            1e-6, 1.0)
        alpha_r = roughness * roughness
        alpha2 = alpha_r * alpha_r
        ggx_k = (alpha_r + 2 * roughness + 1) / 8.0
        FMi = (-5.55473 * voh - 6.98316) * voh
        frac0 = self.fresnel + (1 - self.fresnel) * torch.pow(2.0, FMi)
        frac = frac0 * alpha2[:, None]
        nom0 = noh * noh * (alpha2[:, None] - 1) + 1
        nom1 = nov * (1 - ggx_k) + ggx_k
        nom2 = nol * (1 - ggx_k[:, None]) + ggx_k[:, None]
        nom = (4 * math.pi * nom0 * nom0 * nom1[:, None] * nom2).clamp(
            1e-6, 4 * math.pi)
        spec_ggx = frac / nom  # [B, L, 1, S, S]
        specular = spec_ggx

        diff_cos = torch.sum(nml[:, None] * ggx_L, 2, keepdim=True).clamp(
            0.0, 1.0)
        spec = torch.stack([(spec_ggx**p).clamp(max=1.0)
                            for p in self.spec_powers], 2)
        pos_cos = (diff_cos[:, :, None] > 0).to(spec.dtype)
        if self.shadow:
            diff_p = torch.sum(diff_cos * li * shadow_map, 1)
            spec_p = torch.sum(spec * li[:, :, None] * shadow_map[:, :, None]
                               * pos_cos, 1)
        else:
            diff_p = torch.sum(diff_cos * li, 1)
            spec_p = torch.sum(spec * li[:, :, None] * pos_cos, 1)
        spec_p = spec_p * 10.0

        feat_p = inv_lint[:, None] * torch.cat([diff_p[:, None], spec_p], 1)

        if self.scaled_albedo:
            tex_mean = tex_mean * (
                torch.sigmoid(self.global_albedo_scale) / 2.0 + 0.7)
        surface_brdf = (tex_mean[:, None] / 255.0) / math.pi + specular
        cosine = torch.einsum("bjknm,bknm->bjnm", ggx_L, nml).clamp(min=0.0)
        phys_rgb = torch.mean(
            4 * math.pi * surface_brdf * li * cosine[:, :, None], dim=1)
        phys_rgb = phys_rgb * (torch.sigmoid(self.global_scale) / 2.0 + 0.3)
        outputs.update(phys_tex=phys_rgb, roughness=roughness)

        if self.view_cond:
            # v in the TBN frame: rows of the frame are (t, -b, n)
            viewout = (v_uv[:, 0:1] * tbn_t - v_uv[:, 1:2] * tbn_b
                       + v_uv[:, 2:3] * tbn_n)
            viewout = interpolate_bilinear(
                viewout, size=tuple(id_pose_feat.shape[2:]))
            id_pose_feat = torch.cat([id_pose_feat, viewout], dim=1)
        outputs["id_pose_conv"] = id_pose_feat

        joint_feat = self.joint_conv_block_tex(id_pose_feat)

        # linear gain/bias branch
        feat_flat = feat_p.reshape(feat_p.shape[0], -1, feat_p.shape[-2],
                                   feat_p.shape[-1])
        z, gainbias = self.featenc(feat_flat.detach())

        scale = 0.707107
        activations = []
        x = joint_feat
        hh = self.init_uv_size
        for i in range(self.n_layers):
            x = interpolate_bilinear(x, size=(hh, hh), align_corners=True)
            x = leaky_relu(getattr(self, f"texmod0_{i}")(x), 0.2)
            activations.append(x)
            hh *= 2
        x = z
        hh = self.init_uv_size
        for i in range(self.n_layers):
            x = interpolate_bilinear(x, size=(hh, hh), align_corners=True)
            x = getattr(self, f"texmod1_{i}")(x) * activations[i]
            hh *= 2
            if i < len(gainbias):
                x = (x + interpolate_bilinear(
                    gainbias[i], size=tuple(x.shape[2:]),
                    align_corners=True)) * scale
        rgb = interpolate_bilinear(x, size=(S, S), align_corners=True)

        if self.shadow and not train:
            rgb = rgb * torch.sum((li / lint_scale[:, None]) * shadow_map, 1)
        rgb = lint_scale * rgb

        outputs.update(
            tex=rgb.clamp(min=0.0),
            verts_displaced=verts_rec_displaced,
            diff_feature=inv_lint * diff_p,
            spec_feature=inv_lint[:, None] * spec_p,
            displacement=displacement,
            feature_normal=nml,
            interm_features2reg=gainbias,
        )
        if self.shadow:
            outputs["shadow"] = shadow_map
        return outputs


class _URHandNet(nn.Module):
    """Inner module of the URHand AutoEncoder."""

    def __init__(self, geo_fn: GeometryModule, lbs_fn: LBSModule,
                 seam_sampler: SeamSampler, renderer: Optional[RenderLayer],
                 shadow_rl: RenderLayer, raw_index_mask: np.ndarray,
                 tex_mean: torch.Tensor, tex_std: float, camera_ids,
                 cal_cfg: Optional[Dict[str, Any]],
                 relight_cfg: Dict[str, Any], uv_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.geo_fn, self.lbs_fn = geo_fn, lbs_fn
        self.seam_sampler, self.renderer = seam_sampler, renderer
        self.tex_std, self.uv_size = tex_std, uv_size
        self.register_buffer("tex_mean", tex_mean, persistent=False)
        self.decoder_relight = ConvTeacherDecoder(
            geo_fn=geo_fn, raw_index_mask=raw_index_mask,
            shadow_rl=shadow_rl, generator=generator, **relight_cfg)
        self.cal = (CalV5(cameras=camera_ids, **cal_cfg)
                    if cal_cfg is not None else None)

    def forward(
        self,
        pose: torch.Tensor,
        campos: torch.Tensor,
        K: Optional[torch.Tensor] = None,
        Rt: Optional[torch.Tensor] = None,
        light_pos: Optional[torch.Tensor] = None,
        light_intensity: Optional[torch.Tensor] = None,
        camera_idx: Optional[torch.Tensor] = None,
        iteration: Optional[torch.Tensor] = None,
        train: bool = False,
    ) -> Dict[str, Any]:
        B = pose.shape[0]
        S = self.uv_size
        tex_mean = self.tex_mean.expand(B, 3, S, S)
        preds: Dict[str, Any] = {}

        lbs = self.lbs_fn
        zeros = torch.zeros((B,) + tuple(lbs.lbs_template_verts.shape[-2:]),
                            dtype=pose.dtype, device=pose.device)
        verts_rec = lbs.pose(zeros, pose)
        mesh_id_only = (lbs.lbs_template_verts
                        * lbs.global_scaling[0]).expand(verts_rec.shape)

        # per-joint Euler XYZ -> axis-angle
        eul = pose.reshape(B, -1, 3)
        hand_pose_aa = matrix_to_axisangle(
            quat_to_matrix(quat_from_xyz(eul))).reshape(B, -1)

        relight_preds = self.decoder_relight(
            hand_pose_aa.detach(), mesh_id_only.detach(), tex_mean.detach(),
            verts_rec.detach(), campos, light_pos, light_intensity, train)
        preds["interm_features2reg"] = relight_preds["interm_features2reg"]

        phys_tex_rec = (relight_preds["phys_tex"] * 255.0).clamp(0, 255)

        # gain/bias composition
        tex = relight_preds["tex"]
        gain = tex[:, 0:3]
        bias = tex[:, 3:4] if tex.shape[1] == 4 else tex[:, 3:6]
        tex_rec = tex_mean * gain + bias * self.tex_std
        if self.cal is not None and camera_idx is not None:
            tex_rec = self.cal(tex_rec, camera_idx)
        # jnp.clip's gradient: texels where the clipped texture is 0 are
        # exactly 0 here (0 * cal's gain + its bias at the identity init)
        tex_rec = clip(tex_rec, 0.0, 255.0)
        preds["texrec_before_warp"] = tex_rec
        tex_rec = self.seam_sampler.resample(tex_rec)

        verts_displaced = relight_preds["verts_displaced"]
        preds.update(
            geom=verts_displaced,
            tex_rec=tex_rec,
            displacement=relight_preds["displacement"],
            roughness=relight_preds["roughness"],
        )

        if self.renderer is not None and K is not None:
            tex_seg = torch.ones_like(tex_rec[:, :1])
            rgb_out = self.renderer(verts_displaced,
                                    torch.cat([tex_rec, tex_seg], 1), K, Rt,
                                    edge_grad=train)
            preds["rgb"] = rgb_out["render"][:, :3]
            preds["rendered_rgb"] = preds["rgb"]
            preds["alpha"] = rgb_out["render"][:, 3:4]
            preds["rendered_mask"] = preds["alpha"]
            phys_out = self.renderer(verts_displaced,
                                     torch.cat([phys_tex_rec, tex_seg], 1),
                                     K, Rt, edge_grad=train)
            preds["rendered_phys_rgb"] = phys_out["render"][:, :3]
            preds["depth"] = rgb_out["depth_img"][:, None].detach()

            # normal visualization (a render of detached features)
            nrm = relight_preds["feature_normal"].detach()
            nrm_cam = torch.einsum("bchw,bdc->bdhw", nrm, Rt[:, :3, :3])
            feat_normal = (1 - nrm_cam) * 127.5
            nrm_out = self.renderer(
                verts_displaced.detach(),
                torch.cat([feat_normal, torch.ones_like(feat_normal[:, :1])],
                          1), K, Rt, edge_grad=False)
            preds["normals"] = nrm_out["render"][:, :3]
        return preds


class AutoEncoder(ModelFacade):
    """Facade: builds the UV tables, the skeleton, the seam sampler, the
    shadow and image renderers once and the inner module on ``device``, its
    parameters drawn from ``generator`` (seed 0 when none is given).

    ``learn_blur`` exists because the eval entry point passes it to every
    model; URHand has no learned blur, so ``True`` raises."""

    def __init__(
        self,
        assets: Any,
        cal: Optional[Dict[str, Any]] = None,
        renderer: Optional[Dict[str, Any]] = None,
        relight: Optional[Dict[str, Any]] = None,
        blur_enable: bool = False,
        blur_sig: float = 1.0,
        blur_size: int = 3,
        vis_feature: bool = False,
        impaint_uv: bool = True,
        uv_size: int = 1024,
        global_scaling: float = 10.0,
        shadow_size: Optional[int] = None,
        learn_blur: bool = False,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        if learn_blur:
            raise ValueError("URHand has no learned blur (learn_blur=True)")
        self.device = dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.assets = assets
        self.cameras = [str(c) for c in assets.camera_ids]
        relight = dict(relight or {})
        uv_size = int(relight.pop("uv_size", uv_size))
        shadow_size = shadow_size or uv_size
        topo = assets.topology

        self.geo_fn = GeometryModule(
            np.asarray(topo.vi), np.asarray(topo.vt), np.asarray(topo.vti),
            np.asarray(topo.v2uv), uv_size=uv_size, impaint=impaint_uv,
            device=dev)
        self.lbs_fn = LBSModule(
            assets.lbs_model_json, assets.lbs_config_dict,
            np.asarray(assets.template_mesh_unscaled)[None],
            assets.skeleton_scales, [global_scaling] * 3, device=dev)
        gf = self.geo_fn
        raw_index = make_uv_vert_index(gf.vt_np, gf.vi_np, gf.vti_np,
                                       uv_size=uv_size, flip_uv=False)
        raw_index_mask = (raw_index != -1).any(-1)

        tex_mean = torch.from_numpy(
            np.asarray(assets.color_mean, np.float32)).to(dev)
        if tex_mean.shape[-1] != uv_size:
            tex_mean = interpolate_bilinear(tex_mean[None],
                                            size=(uv_size, uv_size))[0]
        self.tex_std = 64.0

        seam = assets.get("seam_data_1024", None)
        self.seam_sampler = SeamSampler(
            seam if seam is not None else _identity_seam_data(uv_size),
            device=dev)

        shadow_rl = RenderLayer(
            h=shadow_size, w=shadow_size, vi=gf.vi_np, vt=gf.vt_np,
            vti=gf.vti_np, flip_uvs=False, device=dev,
            max_faces_per_tile=int(relight.pop("shadow_max_faces", 128)),
            chunk=16)

        rl = None
        if renderer is not None:
            rl_keys = ("tile_size", "max_tiles_per_face",
                       "max_faces_per_tile", "chunk", "pair_budget_mult",
                       "z_near")
            rl = RenderLayer(
                h=int(renderer["image_height"]),
                w=int(renderer["image_width"]), vi=gf.vi_np, vt=gf.vt_np,
                vti=gf.vti_np, flip_uvs=False, device=dev,
                **{k: v for k, v in renderer.items() if k in rl_keys})

        cal_cfg = None
        if cal is not None:
            cal_cfg = dict(cal)
            cal_cfg["identity_camera"] = str(cal_cfg["identity_camera"])
        self.cal_enabled = cal is not None

        relight.pop("masked_refiner_input", None)  # implied by impaint_uv
        relight.setdefault("init_uv_size", 64)
        relight.setdefault("pose_enc_dims", 64)
        relight.setdefault("disp_enc_dims", (64, 64, 64, 64, 64, 64))
        relight.setdefault("disp_scale", 0.3)
        relight["uv_size"] = uv_size
        relight["disp_enc_dims"] = tuple(relight["disp_enc_dims"])

        self.module = _URHandNet(
            geo_fn=gf, lbs_fn=self.lbs_fn, seam_sampler=self.seam_sampler,
            renderer=rl, shadow_rl=shadow_rl, raw_index_mask=raw_index_mask,
            tex_mean=tex_mean, tex_std=self.tex_std,
            camera_ids=tuple(self.cameras), cal_cfg=cal_cfg,
            relight_cfg=relight, uv_size=uv_size, generator=generator,
        ).to(dev)
        self.module.eval()

    def name_to_idx(self, camera_ids) -> torch.Tensor:
        return torch.tensor([self.cameras.index(str(c)) for c in camera_ids],
                            dtype=torch.int32, device=self.device)


class URHandSummary:
    """Host-side images for the training log: the render, the phys render,
    the normals and the ground truth as [B, 3, H, W] arrays in [0, 1]."""

    def __call__(self, preds: Dict[str, Any], batch: Dict[str, Any]
                 ) -> Dict[str, np.ndarray]:
        def host(x):
            return x.detach().float().cpu().numpy()

        out = {"render": np.clip(host(preds["rgb"]) / 255.0, 0, 1)}
        if "rendered_phys_rgb" in preds:
            out["phys"] = np.clip(host(preds["rendered_phys_rgb"]) / 255.0,
                                  0, 1)
        if "normals" in preds:
            out["normals"] = np.clip(host(preds["normals"]) / 255.0, 0, 1)
        if "image" in batch:
            out["gt"] = np.clip(host(batch["image"]) / 255.0, 0, 1)
        return out
