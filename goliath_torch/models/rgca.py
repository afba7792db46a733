"""RGCA, Relightable Gaussian Codec Avatar heads (port of the JAX
package's models/rgca.py).

VAE encoder over (registration verts, unwrapped color texture) -> latent;
GeomDecoder MLP -> face mesh; PrimDecoder conv-transpose pyramids decode
per-texel Gaussian parameters (delta-pos, quat, scale, opacity), diffuse SH,
roughness and view-conditioned specular visibility/normal. Diffuse =
albedo * <SH, light SH>; specular = reflection-lobe angular Gaussian
against point lights (ops/sg.py). Rendered with the splat renderer
(ops/gsplat.py) in head-relative coordinates, one sample at a time.

``train=True`` adds the encoder's reparameterization noise, the random
backlit regularization branch of the decoder and the background
compositing; ``CalV5`` and ``LearnableBlur`` apply whenever the batch names
its cameras. The random draws come from the model's ``torch.Generator``;
each can also be passed in (``noise``, ``light_dir``), which is how a test
feeds both packages the same values. ``remat_decoder`` recomputes the prim
decoder in the backward (``torch.utils.checkpoint``) instead of keeping its
uv-slab activations across the splat render; without it only the two conv
pyramids are recomputed, as in the JAX package. The draws are made outside
the recomputed calls, which do not replay an explicit generator. The envmap
branch is not ported yet (ROADMAP queue 1) and raises.

Submodules and parameters carry the flax names (``encoder.tex0.weight_v``,
``decoder.albedo``, ...), so ``goliath_torch.convert.params_from_jax`` maps
one to one.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from goliath_torch.models.base import ModelFacade
from goliath_torch.nn.color_cal import CalV5
from goliath_torch.nn.dof_cal import LearnableBlur
from goliath_torch.nn.layers import (
    Conv2dWNUB,
    ConvTranspose2dWNUB,
    LinearWN,
    leaky_relu,
)
from goliath_torch.ops import gsplat
from goliath_torch.ops.backend import resolve_device
from goliath_torch.ops.sg import evaluate_gaussian
from goliath_torch.utils import sh
from goliath_torch.utils.geom import GeometryModule

primscale_range: Tuple[float, float] = (0.1, 20.0)


def _normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12
               ) -> torch.Tensor:
    # eps inside the sqrt, as the JAX package (finite at v == 0)
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps)


class Encoder(nn.Module):
    """Joint geometry + texture encoder."""

    def __init__(self, n_embs: int, n_verts_in: int, tex_size: int = 1024,
                 noise_std: float = 1.0, mean_scale: float = 0.1,
                 logvar_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.noise_std = noise_std
        self.mean_scale = mean_scale
        self.logvar_scale = logvar_scale
        g = generator
        self.geommod = LinearWN(n_verts_in * 3, 256, generator=g)
        widths = [32, 32, 64, 64, 128, 128, 256, 256]
        n_down = int(math.log2(tex_size // 4))
        widths = widths[-n_down:] if n_down <= len(widths) else widths
        self.n_tex = len(widths)
        cin, size = 3, tex_size
        for i, w in enumerate(widths):
            size //= 2
            self.add_module(f"tex{i}", Conv2dWNUB(cin, w, size, size, 4, 2, 1,
                                                  generator=g))
            cin = w
        self.jointmod = LinearWN(256 + cin * size * size, 512, generator=g)
        self.mean = LinearWN(512, n_embs, alpha=1.0, generator=g)
        self.logvar = LinearWN(512, n_embs, alpha=1.0, generator=g)

    def forward(self, geom: torch.Tensor, color: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``noise`` [B, n_embs] (standard normal) turns the training
        reparameterization on; without it ``embs`` is the mean."""
        B = geom.shape[0]
        geomout = leaky_relu(self.geommod(geom.reshape(B, -1)))
        h = color / 255.0 - 0.5
        for i in range(self.n_tex):
            h = leaky_relu(getattr(self, f"tex{i}")(h))
        joint = torch.cat([geomout, h.reshape(B, -1)], dim=1)
        joint = leaky_relu(self.jointmod(joint))
        embs_mu = self.mean(joint) * self.mean_scale
        embs_logvar = self.logvar(joint) * self.logvar_scale
        embs = embs_mu
        if noise is not None:
            embs = embs_mu + torch.exp(embs_logvar) * noise * self.noise_std
        return dict(embs=embs, embs_mu=embs_mu, embs_logvar=embs_logvar)


class GeomDecoder(nn.Module):
    """Latent -> coarse face mesh."""

    def __init__(self, n_embs: int, verts_mean: np.ndarray, verts_std: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_verts = verts_mean.shape[-2]
        self.fc1 = LinearWN(n_embs, 256, generator=generator)
        self.fc2 = LinearWN(256, 3 * n_verts, alpha=1.0, generator=generator)
        self.verts_std = verts_std
        self.register_buffer(
            "verts_mean", torch.from_numpy(np.asarray(verts_mean, np.float32)),
            persistent=False)

    def forward(self, embs: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = leaky_relu(self.fc1(embs))
        geom = self.fc2(h).reshape(embs.shape[0], -1, 3)
        return dict(face_geom=geom * self.verts_std + self.verts_mean[None])


def _pyramid_widths(slabsize: int):
    """Conv-transpose ladder 8 -> slabsize; reference channels at 1024."""
    full = [256, 256, 128, 128, 64, 32, 16]  # input widths of the 7 ups
    n_ups = int(math.log2(slabsize // 8))
    if n_ups >= len(full):
        return full
    return [256] + full[-(n_ups - 1):] if n_ups > 1 else [256]


class PrimDecoder(nn.Module):
    """Latent (+ view) -> per-texel relightable Gaussians."""

    def __init__(self, n_embs: int, geo_fn: GeometryModule,
                 color_mean: np.ndarray, slabsize: int = 1024,
                 n_diff_sh: int = 8, n_color_sh: int = 3,
                 remat_pyramids: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.geo_fn = geo_fn
        self.slabsize = slabsize
        self.remat_pyramids = remat_pyramids
        self.n_diff_sh = n_diff_sh
        self.n_color_coeffs = (n_color_sh + 1) ** 2
        n_mono = (n_diff_sh + 1) ** 2 - self.n_color_coeffs
        self.n_diff_coeffs = 3 * self.n_color_coeffs + n_mono
        g = generator
        self.encmod = LinearWN(n_embs, 256 * 8 * 8, generator=g)
        self.viewmod = LinearWN(3, 8, generator=g)
        self.n_ups = self._add_pyramid("vnocond", 256,
                                       self.n_diff_coeffs + 11 + 1, g)
        self._add_pyramid("vcond", 256 + 8, 4, g)
        rgb_mean = np.asarray(color_mean, np.float32) / 255.0
        albedo = (2.0 * rgb_mean / 2.2974).transpose(1, 2, 0).reshape(1, -1, 3)
        self.albedo = nn.Parameter(torch.from_numpy(np.ascontiguousarray(albedo)))

    def _add_pyramid(self, name: str, cin: int, out_ch: int,
                     generator: Optional[torch.Generator]) -> int:
        widths = _pyramid_widths(self.slabsize)
        size = 8
        for i, w_out in enumerate(widths[1:] + [None]):
            size *= 2
            cout = w_out if w_out is not None else out_ch
            alpha = 0.2 if w_out is not None else 1.0
            self.add_module(f"{name}{i}", ConvTranspose2dWNUB(
                cin, cout, size, size, 4, 2, 1, alpha=alpha,
                generator=generator))
            cin = cout
        return len(widths)

    def _pyramid_layers(self, name: str, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_ups):
            h = getattr(self, f"{name}{i}")(h)
            if i < self.n_ups - 1:
                h = leaky_relu(h)
        return h

    def _pyramid(self, name: str, h: torch.Tensor) -> torch.Tensor:
        if self.remat_pyramids and torch.is_grad_enabled():
            return checkpoint(self._pyramid_layers, name, h,
                              use_reentrant=False)
        return self._pyramid_layers(name, h)

    def forward(self, embs, geom, headrel_campos, light_intensity,
                headrel_light_pos, headrel_light_sh, n_lights,
                light_dir: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``light_dir`` [B, 1, 3] (any length) turns on the training-only
        backlit branch: the diffuse color under one unit light from that
        direction (``color_rand``) and the cosine between it and each
        specular normal (``cos_weight``)."""
        B = embs.shape[0]
        ncc, ndc = self.n_color_coeffs, self.n_diff_coeffs

        postex = self.geo_fn.to_uv(geom)  # [B, 3, S, S]
        primposbase = postex.permute(0, 2, 3, 1).reshape(B, -1, 3)
        tn = self.geo_fn.to_uv(self.geo_fn.vn(geom))
        tn = tn / torch.sqrt(torch.sum(tn * tn, dim=1, keepdim=True) + 1e-12)
        primnmlbase = tn.permute(0, 2, 3, 1).reshape(B, -1, 3)

        h0 = leaky_relu(self.encmod(embs)).reshape(-1, 256, 8, 8)
        f_vnocond = self._pyramid("vnocond", h0)

        view = leaky_relu(self.viewmod(_normalize(headrel_campos)))
        view = view[:, :, None, None].expand(-1, -1, 8, 8)
        f_vcond = self._pyramid("vcond", torch.cat([h0, view], dim=1))
        f_vcond = f_vcond.permute(0, 2, 3, 1).reshape(B, -1, 4)

        # color and mono SH factors stay apart and are contracted with the
        # light SH one at a time, as in the JAX package
        diff_raw = f_vnocond[:, :ndc].permute(0, 2, 3, 1).reshape(B, -1, ndc)
        shs_color = diff_raw[..., : ncc * 3].reshape(B, -1, 3, ncc)
        shs_mono = diff_raw[..., ncc * 3:]

        def eval_diff_sh(light_sh):
            """light_sh [B, 3, K] -> diffuse radiance [B, N, 3]."""
            lc = light_sh[..., :ncc]
            lm = light_sh[..., ncc:]
            return (torch.einsum("bnck,bck->bnc", shs_color, lc)
                    + torch.einsum("bnk,bck->bnc", shs_mono, lm))

        f_geom = f_vnocond[:, ndc: ndc + 11].permute(0, 2, 3, 1)
        f_geom = f_geom.reshape(B, -1, 11)
        primpos = f_geom[..., 0:3] + primposbase
        primqvec = _normalize(f_geom[..., 3:7])
        primscale = F.softplus(f_geom[..., 7:10])
        opacity = torch.sigmoid(f_geom[..., 10:11])

        sigma = f_vnocond[:, ndc + 11:].permute(0, 2, 3, 1).reshape(B, -1)
        sigma = (torch.exp(sigma) * 0.1).clamp(min=0.01)

        spec_vis = torch.sigmoid(f_vcond[..., :1])
        spec_dnml = f_vcond[..., 1:]
        spec_nml = _normalize(spec_dnml + primnmlbase)

        albedo = self.albedo.expand((B,) + self.albedo.shape[1:])
        diff_color = albedo * eval_diff_sh(headrel_light_sh)

        view_local = _normalize(primpos - headrel_campos[:, None])
        ref_dirs = view_local - 2.0 * torch.sum(
            view_local * spec_nml, dim=-1, keepdim=True) * spec_nml
        spec_color = evaluate_gaussian(
            ref_dirs, sigma, light_intensity, headrel_light_pos, primpos,
            n_lights, w_type=0) * spec_vis

        color = diff_color.clamp(min=0.0) + spec_color
        preds = dict(
            color=color.clamp(min=0.0),
            opacity=opacity,
            primpos=primpos,
            primqvec=primqvec,
            primscale=primscale.clamp(*primscale_range),
            primscale_preclip=primscale,
            sigma=sigma,
            spec_vis=spec_vis,
            spec_nml=spec_nml,
            spec_dnml=spec_dnml,
            diff_color=diff_color,
            spec_color=spec_color,
            primnmlbase=primnmlbase,
        )
        if light_dir is not None:
            light_dir = _normalize(light_dir).detach()
            preds["cos_weight"] = torch.sum(light_dir * spec_nml, dim=-1,
                                            keepdim=True)
            li = torch.ones_like(light_intensity[:, :1])
            sh_coeffs = sh.dir2sh(self.n_diff_sh, light_dir)
            light_sh = torch.sum(sh_coeffs[:, :, None] * li[..., None], dim=1)
            preds["color_rand"] = eval_diff_sh(light_sh).clamp(min=0.0)
        return preds


class _RGCANet(nn.Module):
    """Inner module of the RGCA AutoEncoder."""

    def __init__(self, geo_fn: GeometryModule, n_verts_in: int,
                 verts_mean: np.ndarray, verts_var: float,
                 color_mean: np.ndarray, camera_ids: Tuple[str, ...],
                 encoder_cfg: Dict[str, Any], decoder_cfg: Dict[str, Any],
                 image_height: int, image_width: int, n_embs: int,
                 n_diff_sh: int, cal_cfg: Optional[Dict[str, Any]],
                 learn_blur_enabled: bool, tex_size: int, slabsize: int,
                 render_cfg: Dict[str, Any], remat_decoder: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_height = image_height
        self.image_width = image_width
        self.n_embs = n_embs
        self.n_diff_sh = n_diff_sh
        self.render_cfg = dict(render_cfg)
        self.remat_decoder = remat_decoder
        # source of the training draws (encoder noise, backlit direction)
        self.generator = generator
        self.encoder = Encoder(n_embs, n_verts_in, tex_size,
                               generator=generator, **encoder_cfg)
        self.geomdecoder = GeomDecoder(
            n_embs, verts_mean, float(math.sqrt(float(verts_var))),
            generator=generator)
        self.decoder = PrimDecoder(n_embs, geo_fn, color_mean, slabsize,
                                   n_diff_sh, generator=generator,
                                   remat_pyramids=not remat_decoder,
                                   **decoder_cfg)
        self.cal = CalV5(cameras=camera_ids, **cal_cfg) if cal_cfg else None
        self.learn_blur = (LearnableBlur(cameras=camera_ids)
                           if learn_blur_enabled else None)

    def forward(
        self,
        head_pose: torch.Tensor,
        campos: torch.Tensor,
        registration_vertices: torch.Tensor,
        color: torch.Tensor,
        light_intensity: torch.Tensor,
        light_pos: torch.Tensor,
        n_lights: torch.Tensor,
        K: torch.Tensor,
        Rt: torch.Tensor,
        camera_idx: Optional[torch.Tensor] = None,
        background: Optional[torch.Tensor] = None,
        is_fully_lit_frame: Optional[torch.Tensor] = None,
        preconv_envmap: Optional[Tuple[torch.Tensor, ...]] = None,
        lightrot: Optional[torch.Tensor] = None,
        envbg: Optional[torch.Tensor] = None,
        train: bool = False,
        noise: Optional[torch.Tensor] = None,
        light_dir: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """With ``train=True`` the encoder noise [B, n_embs] and the backlit
        direction [B, 1, 3] are drawn from the model's generator unless
        ``noise`` / ``light_dir`` give them."""
        if preconv_envmap is not None:
            raise NotImplementedError(
                "the RGCA envmap branch is not ported yet (ROADMAP queue 1, "
                "utils/envmap.py and utils/mipmap_sampler.py)")
        B = head_pose.shape[0]
        dev = head_pose.device
        if train:
            if noise is None:
                noise = torch.randn((B, self.n_embs),
                                    generator=self.generator).to(dev)
            if light_dir is None:
                light_dir = (torch.rand((B, 1, 3), generator=self.generator)
                             - 0.5).to(dev)
        else:
            noise = light_dir = None
        light_intensity = light_intensity.expand(
            light_intensity.shape[:2] + (3,))

        # head-relative coordinates
        head_pose_4x4 = torch.cat(
            [head_pose, torch.zeros_like(head_pose[:, :1])], dim=1)
        head_pose_4x4[:, 3, 3] = 1.0
        headrel_Rt = Rt @ head_pose_4x4
        R_head = head_pose[:, :3, :3]
        headrel_campos = torch.einsum(
            "bj,bjk->bk", campos - head_pose[:, :3, 3], R_head)
        headrel_light_pos = torch.einsum(
            "blj,bjk->blk", light_pos - head_pose[:, None, :3, 3], R_head)
        sh_coeffs = sh.dir2sh(self.n_diff_sh, _normalize(headrel_light_pos))
        L = light_pos.shape[1]
        lmask = (torch.arange(L, device=n_lights.device)[None]
                 < n_lights[:, None]).to(sh_coeffs.dtype)
        headrel_light_sh = torch.sum(
            sh_coeffs[:, :, None] * light_intensity[..., None]
            * lmask[:, :, None, None], dim=1)

        enc_preds = self.encoder(registration_vertices, color, noise)
        embs = enc_preds["embs"]
        geom = self.geomdecoder(embs)["face_geom"]
        dec_args = (embs, geom, headrel_campos, light_intensity,
                    headrel_light_pos, headrel_light_sh, n_lights, light_dir)
        if self.remat_decoder and torch.is_grad_enabled():
            dec_preds = checkpoint(self.decoder, *dec_args,
                                   use_reentrant=False)
        else:
            dec_preds = self.decoder(*dec_args)

        out = gsplat.render(
            self.image_width, self.image_height, K, headrel_Rt,
            dec_preds["primpos"], dec_preds["primqvec"],
            dec_preds["primscale"], dec_preds["opacity"], dec_preds["color"],
            return_depth=True, **self.render_cfg)
        rgb = out["render"]
        alpha = 1.0 - out["final_T"]
        depth = out["depth"] / alpha.clamp(0.05, 1.0)

        if self.cal is not None and camera_idx is not None:
            rgb = self.cal(rgb, camera_idx)
        if train and background is not None and is_fully_lit_frame is not None:
            bg = background[:, :3] * is_fully_lit_frame.reshape(B, 1, 1, 1)
            rgb = rgb + (1.0 - alpha) * bg

        preds = {
            "geom": geom,
            "headrel_light_sh": headrel_light_sh,
            **enc_preds,
            **dec_preds,
            "rgb": rgb,
            "alpha": alpha,
            "depth": depth,
        }
        if self.learn_blur is not None and camera_idx is not None:
            preds["rgb"] = self.learn_blur(rgb, camera_idx)
            preds["learn_blur_weights"] = self.learn_blur.reg(camera_idx)
        return preds


class AutoEncoder(ModelFacade):
    """Facade: builds the UV tables once and the inner module on
    ``device``, its parameters drawn from ``generator`` (seed 0 when none
    is given), which also feeds the training draws."""

    def __init__(
        self,
        encoder: Dict[str, Any],
        decoder: Dict[str, Any],
        assets: Any,
        image_height: int,
        image_width: int,
        cal: Optional[Dict[str, Any]] = None,
        n_embs: int = 256,
        n_diff_sh: int = 8,
        learn_blur: bool = True,
        bg_weight: float = 1.0,
        uv_size: int = 1024,
        render: Optional[Dict[str, Any]] = None,
        remat_decoder: bool = True,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        del bg_weight  # unused by the JAX forward too
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.assets = assets
        self.image_height = image_height
        self.image_width = image_width
        self.cameras = [str(c) for c in assets.camera_ids]
        topo = assets.topology
        self.geo_fn = GeometryModule(
            np.asarray(topo.vi), np.asarray(topo.vt), np.asarray(topo.vti),
            None, uv_size=uv_size, flip_uv=True, impaint=False,
            device=self.device)
        cal_cfg = None
        if cal is not None:
            cal_cfg = dict(cal)
            cal_cfg["identity_camera"] = str(cal_cfg["identity_camera"])
        self.module = _RGCANet(
            geo_fn=self.geo_fn,
            n_verts_in=int(np.asarray(topo.v).shape[0]),
            verts_mean=np.asarray(assets.verts_mean, np.float32),
            verts_var=float(assets.verts_var),
            color_mean=np.asarray(assets.color_mean, np.float32),
            camera_ids=tuple(self.cameras),
            encoder_cfg=dict(encoder),
            decoder_cfg=dict(decoder),
            image_height=image_height,
            image_width=image_width,
            n_embs=n_embs,
            n_diff_sh=n_diff_sh,
            cal_cfg=cal_cfg,
            learn_blur_enabled=bool(learn_blur),
            tex_size=int(np.asarray(assets.color_mean).shape[-1]),
            slabsize=uv_size,
            render_cfg=dict(render or {}),
            remat_decoder=bool(remat_decoder),
            generator=generator,
        ).to(self.device)
        self.module.eval()

    def name_to_idx(self, camera_ids) -> torch.Tensor:
        return torch.tensor([self.cameras.index(str(c)) for c in camera_ids],
                            dtype=torch.int32, device=self.device)


class RGCASummary:
    """Host-side image grids for the training log (port of the JAX
    package's RGCASummary): uv slabs of the shading terms and the render
    beside the ground truth, as [B, 3, H, W] arrays in [0, 1]."""

    def __call__(self, preds: Dict[str, Any], batch: Dict[str, Any]
                 ) -> Dict[str, np.ndarray]:
        from goliath_torch.utils.image import linear2srgb, scale_diff_image

        def host(x):
            return x.detach().float().cpu()

        diag: Dict[str, np.ndarray] = {}
        diff_color = host(preds["diff_color"]).clamp(0, 1)
        spec_color = host(preds["spec_color"]).clamp(0, 1)
        bs, n = diff_color.shape[:2]
        s = int(math.sqrt(n))

        def slab(x, name):
            img = x[:, : s * s].reshape(bs, s, s, -1).permute(0, 3, 1, 2)
            diag[name] = img.clamp(0, 1).numpy()

        slab(linear2srgb(diff_color + spec_color), "sh_slab")
        slab(linear2srgb(diff_color), "diff_sh_slab")
        slab(linear2srgb(spec_color), "spec_slab")
        slab(host(preds["spec_nml"]) * 0.5 + 0.5, "spec_normal_slab")
        slab(host(preds["spec_vis"]), "spec_vis_slab")
        slab(host(preds["opacity"]), "opacity_slab")

        rgb = host(preds["rgb"])
        diag["render"] = linear2srgb(rgb).clamp(0, 1).numpy()
        diag["alpha"] = host(preds["alpha"]).repeat(1, 3, 1, 1).clamp(
            0, 1).numpy()
        if "image" in batch:
            gt = host(batch["image"])
            diag["gt"] = linear2srgb(gt).clamp(0, 1).numpy()
            diag["diff"] = scale_diff_image(rgb - gt).clamp(0, 1).numpy()
        return diag
