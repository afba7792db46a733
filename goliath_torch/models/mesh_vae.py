"""Mesh-VAE full-body avatar (port of the JAX package's models/mesh_vae.py).

The encoder takes the LBS-unposed registration geometry as a UV map and
gives a body latent plus a face latent from the face UV quadrant; the
ConvDecoder mixes spatially masked pose conditioning with latent pyramids
into a geometry-delta UV map and a mean texture; UNetViewDecoder adds the
view-dependent texture; ShadowUNet maps ambient occlusion to a shadow map
(or PoseToShadow, when configured, replaces it); UpscaleNet pixel-shuffles
uv -> tex size; the texture is composited (x std + mean, x shadow) with
seam-correct resampling and rendered with the mesh rasterizer
(ops/rasterizer.py: binning on K4, the z-buffer K5).

``train=True`` adds the encoders' reparameterization noise (drawn from the
model's generator unless the batch gives ``noise`` / ``face_noise``) and,
with PoseToShadow, its distillation target ``pose_shadow_map`` beside
ShadowUNet's ``shadow_map`` (eval takes the distilled map instead). While
grad is enabled the decoder's up-conv trunk is recomputed in the backward
(``torch.utils.checkpoint``) instead of keeping its activations, as the
JAX package remats it. ``MeshVAESummary`` gives the training log's images.

Submodules and parameters carry the flax names (``decoder.conv_block0``,
``encoder_face.encoder.joint0``, ``shadow_net.shadow_pred``, ...), so
``goliath_torch.convert.params_from_jax`` maps the JAX parameters one to
one.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from goliath_torch.models.base import ModelFacade
from goliath_torch.nn.blocks import (
    ConvBlock,
    ConvDownBlock,
    UpConvBlockDeep,
    pixel_shuffle,
    tile2d,
)
from goliath_torch.nn.color_cal import CalV5
from goliath_torch.nn.dof_cal import LearnableBlur
from goliath_torch.nn.layers import Conv2dWNUB, LinearWN, leaky_relu
from goliath_torch.nn.shadow import PoseToShadow, ShadowUNet
from goliath_torch.nn.unet import UNetWB
from goliath_torch.ops.backend import resolve_device
from goliath_torch.ops.rasterizer import RenderLayer
from goliath_torch.utils.geom import (
    GeometryModule,
    compute_view_cos,
    depth_discontinuity_mask,
)
from goliath_torch.utils.image import gaussian_blur_np
from goliath_torch.utils.lbs import LBSModule
from goliath_torch.utils.sampling import interpolate_bilinear
from goliath_torch.utils.seams import SeamSampler

logger = logging.getLogger(__name__)


def _buffer(module: nn.Module, name: str, value: np.ndarray) -> None:
    module.register_buffer(
        name, torch.from_numpy(np.ascontiguousarray(value, np.float32)),
        persistent=False)


class CameraPixelBias(nn.Module):
    """Per-camera screen-space bias, learned at 1/ds_rate resolution."""

    def __init__(self, image_height: int, image_width: int, n_cameras: int,
                 ds_rate: int):
        super().__init__()
        self.image_height, self.image_width = image_height, image_width
        self.bias = nn.Parameter(torch.zeros(
            n_cameras, 1, image_height // ds_rate, image_width // ds_rate))

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        return interpolate_bilinear(
            self.bias[idxs.long()],
            size=(self.image_height, self.image_width))


class Encoder(nn.Module):
    """Masked UV-geometry encoder."""

    def __init__(self, n_embs: int, mask: Any, enc_size: int = 512,
                 noise_std: float = 1.0, mean_scale: float = 0.1,
                 logvar_scale: float = 0.1, verts_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        S, g = enc_size, generator
        self.n_embs, self.enc_size = n_embs, S
        self.noise_std, self.mean_scale = noise_std, mean_scale
        self.logvar_scale, self.verts_scale = logvar_scale, verts_scale
        mask_t = torch.from_numpy(
            np.asarray(mask, np.float32)[None, None].copy())
        if mask_t.shape[-2:] != (S, S):
            mask_t = interpolate_bilinear(mask_t, size=(S, S))
        self.register_buffer("mask", (mask_t > 0).float(), persistent=False)
        self.verts_conv = ConvDownBlock(3, 8, S, generator=g)
        widths = [(8, 16), (16, 32), (32, 32), (32, 64), (64, 128),
                  (128, 128)]
        n_down = int(math.log2(S // 4)) - 1
        widths = widths[-n_down:]
        widths[0] = (8, widths[0][1])
        size = S // 2
        for i, (cin, cout) in enumerate(widths):
            self.add_module(f"joint{i}",
                            ConvDownBlock(cin, cout, size, generator=g))
            size //= 2
        self.n_joint = len(widths)
        last = widths[-1][1]
        self.mu = LinearWN(4 * 4 * last, n_embs, alpha=1.0, generator=g)
        self.logvar = LinearWN(4 * 4 * last, n_embs, alpha=1.0, generator=g)

    def forward(self, verts_unposed_uv: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``noise`` [B, n_embs] (standard normal) turns the training
        reparameterization on: embs = mu + exp(logvar) * noise * noise_std
        (exp of logvar, not of half of it, as in the JAX package)."""
        B = verts_unposed_uv.shape[0]
        S = self.enc_size
        x = interpolate_bilinear(verts_unposed_uv * self.verts_scale,
                                 size=(S, S)) * self.mask
        x = self.verts_conv(x)
        for i in range(self.n_joint):
            x = getattr(self, f"joint{i}")(x)
        x = x.reshape(B, -1)
        embs_mu = self.mean_scale * self.mu(x)
        embs_logvar = self.logvar_scale * self.logvar(x)
        embs = embs_mu
        if noise is not None:
            embs = embs_mu + torch.exp(embs_logvar) * noise * self.noise_std
        return dict(embs=embs, embs_mu=embs_mu, embs_logvar=embs_logvar)


class FaceEncoder(nn.Module):
    """Encoder of the face UV quadrant."""

    def __init__(self, n_embs: int, mask: Any, uv_size: int,
                 generator: Optional[torch.Generator] = None, **enc_kwargs):
        super().__init__()
        self.uv_size = uv_size
        mask_np = np.asarray(mask, np.float32)
        face_mask = mask_np[mask_np.shape[0] // 2:, : mask_np.shape[1] // 2]
        self.encoder = Encoder(n_embs, face_mask, generator=generator,
                               **enc_kwargs)

    def forward(self, verts_unposed_uv: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        h = self.uv_size // 2
        preds = self.encoder(verts_unposed_uv[:, :, h:, :h], noise)
        return {f"face_{k}": v for k, v in preds.items()}


class ConvDecoder(nn.Module):
    """Pose + latents -> geometry-delta UV map + mean texture."""

    def __init__(self, geo_fn: GeometryModule, seam_sampler: SeamSampler,
                 uv_size: int, init_uv_size: int, n_pose_dims: int,
                 n_pose_enc_channels: int, n_embs: int,
                 n_embs_enc_channels: int, n_face_embs: int,
                 n_init_channels: int, n_min_channels: int,
                 pose_cond_mask: Any, face_cond_mask: Any,
                 body_cond_mask: Any, tex_scale: float = 0.001,
                 verts_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.geo_fn, self.seam_sampler = geo_fn, seam_sampler
        self.tex_scale, self.verts_scale = tex_scale, verts_scale
        S0 = self.init_uv_size = init_uv_size
        n_blocks = int(math.log2(uv_size // S0))
        self.sizes = [S0 * 2**s for s in range(n_blocks + 1)]
        self.n_channels = [max(n_init_channels // 2**b, n_min_channels)
                           for b in range(n_blocks + 1)]
        face_cond = np.asarray(face_cond_mask, np.float32)[None, None]
        body_cond = np.asarray(body_cond_mask, np.float32)[None, None]
        _buffer(self, "pose_cond", np.asarray(pose_cond_mask, np.float32))
        _buffer(self, "face_cond", face_cond)
        _buffer(self, "non_head_mask",
                np.clip(body_cond * (1.0 - face_cond), 0.0, 1.0))

        self.local_pose_conv_block = ConvBlock(
            n_pose_dims, n_pose_enc_channels, S0, kernel_size=1, padding=0,
            generator=g)
        self.embs_fc = LinearWN(n_embs, 4 * 4 * 128, generator=g)
        embs_widths = [(128, 128), (128, 128), (128, 64),
                       (64, n_embs_enc_channels)]
        embs_widths = embs_widths[-int(math.log2(S0 // 4)):]
        embs_widths[0] = (128, embs_widths[0][1])
        self.n_embs_ups = len(embs_widths)
        for i, (cin, cout) in enumerate(embs_widths):
            self.add_module(f"embs_conv{i}", UpConvBlockDeep(
                cin, cout, 4 * 2 ** (i + 1), generator=g))
        self.face_embs_fc = LinearWN(n_face_embs, 4 * 4 * 32, generator=g)
        face_widths = [(32, 64), (64, 64), (64, n_embs_enc_channels)]
        face_widths = face_widths[-int(math.log2((S0 // 2) // 4)):]
        face_widths[0] = (32, face_widths[0][1])
        self.n_face_ups = len(face_widths)
        for i, (cin, cout) in enumerate(face_widths):
            self.add_module(f"face_conv{i}", UpConvBlockDeep(
                cin, cout, 4 * 2 ** (i + 1), generator=g))
        self.joint_conv_block = ConvBlock(
            n_pose_enc_channels + n_embs_enc_channels, n_init_channels, S0,
            generator=g)
        n_ch = self.n_channels
        for b in range(len(self.sizes) - 1):
            self.add_module(f"conv_block{b}", UpConvBlockDeep(
                n_ch[b] * 2, n_ch[b + 1] * 2, self.sizes[b + 1], groups=2,
                generator=g))
        self.verts_conv = Conv2dWNUB(n_ch[-1], 3, uv_size, uv_size, 3, 1, 1,
                                     alpha=1.0, generator=g)
        self.tex_conv = Conv2dWNUB(n_ch[-1], 3, uv_size, uv_size, 3, 1, 1,
                                   alpha=1.0, generator=g)

    def _up_trunk(self, x: torch.Tensor) -> torch.Tensor:
        for b in range(len(self.sizes) - 1):
            x = getattr(self, f"conv_block{b}")(x)
        return x

    def forward(self, pose: torch.Tensor, embs: torch.Tensor,
                face_embs: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = pose.shape[0]
        S0 = self.init_uv_size
        pose_masked = tile2d(pose[:, 6:], S0) * self.pose_cond
        pose_conv = self.local_pose_conv_block(pose_masked) \
            * self.non_head_mask

        h = leaky_relu(self.embs_fc(embs)).reshape(B, 128, 4, 4)
        for i in range(self.n_embs_ups):
            h = getattr(self, f"embs_conv{i}")(h)
        fh = leaky_relu(self.face_embs_fc(face_embs)).reshape(B, 32, 4, 4)
        for i in range(self.n_face_ups):
            fh = getattr(self, f"face_conv{i}")(fh)
        half = S0 // 2
        patched = (fh * self.face_cond[:, :, half:, :half]
                   + h[:, :, half:, :half]
                   * self.non_head_mask[:, :, half:, :half])
        embs_conv = h.clone()
        embs_conv[:, :, half:, :half] = patched

        joint = self.joint_conv_block(torch.cat([pose_conv, embs_conv], 1))
        x = torch.cat([joint, joint], dim=1)
        # the up-conv trunk to uv_size^2 dominates training memory: recompute
        # it in the backward
        if torch.is_grad_enabled():
            x = checkpoint(self._up_trunk, x, use_reentrant=False)
        else:
            x = self._up_trunk(x)

        x = self.seam_sampler.impaint(x)
        x = self.seam_sampler.resample(x)
        x = self.seam_sampler.resample(x)
        c = self.n_channels[-1]
        verts_uv_delta_rec = self.verts_conv(x[:, :c]) * self.verts_scale
        tex_mean_rec = self.tex_conv(x[:, c:]) * self.tex_scale
        return {
            "geom_delta_rec": self.geo_fn.from_uv(verts_uv_delta_rec),
            "geom_uv_delta_rec": verts_uv_delta_rec,
            "tex_mean_rec": tex_mean_rec,
            "embs_conv": embs_conv,
            "pose_conv": pose_conv,
        }


class UNetViewDecoder(nn.Module):
    """View-conditioned texture."""

    def __init__(self, geo_fn: GeometryModule, net_uv_size: int,
                 n_init_ftrs: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.geo_fn = geo_fn
        self.unet = UNetWB(4, 3, net_uv_size, n_init_ftrs=n_init_ftrs,
                           generator=generator)

    def forward(self, geom_rec, tex_mean_rec, camera_pos):
        view_cos = compute_view_cos(geom_rec, self.geo_fn.vi,
                                    camera_pos).detach()
        view_cos_uv = self.geo_fn.to_uv(view_cos[..., None]).detach()
        cond_view = torch.cat([view_cos_uv, tex_mean_rec], dim=1)
        return {"tex_view_rec": self.unet(cond_view), "cond_view": cond_view}


class UpscaleNet(nn.Module):
    """conv3x3 -> 1x1 pixel-shuffle head."""

    def __init__(self, in_channels: int, out_channels: int, n_ftrs: int,
                 size: int = 1024, upscale_factor: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.conv_block = Conv2dWNUB(in_channels, n_ftrs, size, size, 3, 1, 1,
                                     generator=generator)
        self.out_block = Conv2dWNUB(n_ftrs, out_channels * upscale_factor**2,
                                    size, size, 1, 1, 0, alpha=1.0,
                                    generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.conv_block(x), 0.2)
        return pixel_shuffle(self.out_block(h), self.upscale_factor)


class _MeshVAENet(nn.Module):
    """Inner module of the mesh-VAE AutoEncoder."""

    def __init__(self, geo_fn: GeometryModule, lbs_fn: LBSModule,
                 seam_sampler: SeamSampler, seam_sampler_2k: SeamSampler,
                 renderer: Optional[RenderLayer], tex_mean: torch.Tensor,
                 tex_std: float, masks: Dict[str, np.ndarray],
                 camera_ids, encoder_cfg, encoder_face_cfg, decoder_cfg,
                 decoder_view_cfg, shadow_net_cfg, upscale_net_cfg,
                 pose_to_shadow_cfg, cal_cfg, pixel_cal_cfg,
                 learn_blur_enabled: bool, uv_size: int, tex_size: int,
                 generator: Optional[torch.Generator] = None,
                 **encoder_extra):
        super().__init__()
        g = generator
        # source of the training draws (the encoders' noise)
        self.generator = generator
        self.geo_fn, self.lbs_fn = geo_fn, lbs_fn
        self.seam_sampler, self.seam_sampler_2k = seam_sampler, seam_sampler_2k
        self.renderer = renderer
        self.tex_std, self.tex_size = tex_std, tex_size
        self.register_buffer("tex_mean", tex_mean, persistent=False)
        self._make_encoders(encoder_cfg, encoder_face_cfg, masks, uv_size, g,
                            **encoder_extra)
        self.decoder = ConvDecoder(
            geo_fn, seam_sampler, pose_cond_mask=masks["pose_cond_mask"],
            face_cond_mask=masks["face_cond_mask"],
            body_cond_mask=masks["body_cond_mask"], generator=g,
            **decoder_cfg)
        self.decoder_view = UNetViewDecoder(geo_fn, generator=g,
                                            **decoder_view_cfg)
        self.shadow_net = ShadowUNet(ao_mean=masks["ao_mean"],
                                     interp_mode="bilinear", biases=False,
                                     generator=g, **shadow_net_cfg)
        self.pose_to_shadow = (
            PoseToShadow(generator=g, **pose_to_shadow_cfg)
            if pose_to_shadow_cfg is not None else None)
        self.upscale_net = UpscaleNet(
            in_channels=6, size=uv_size, upscale_factor=tex_size // uv_size,
            out_channels=3, generator=g, **upscale_net_cfg)
        self.cal = (CalV5(cameras=camera_ids, **cal_cfg)
                    if cal_cfg is not None else None)
        self.learn_blur = (LearnableBlur(cameras=camera_ids)
                           if learn_blur_enabled else None)
        self.pixel_cal = (
            CameraPixelBias(n_cameras=len(camera_ids), **pixel_cal_cfg)
            if pixel_cal_cfg is not None else None)

    def _make_encoders(self, encoder_cfg, encoder_face_cfg, masks, uv_size,
                       generator):
        self.encoder = Encoder(mask=1.0 - masks["face_mask"],
                               generator=generator, **encoder_cfg)
        self.encoder_face = FaceEncoder(mask=masks["face_mask"],
                                        uv_size=uv_size, generator=generator,
                                        **encoder_face_cfg)

    def training_draws(self, batch_size: int, device: torch.device,
                       given: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A training batch's draws from the model's generator, in this
        order: the encoders' noise [B, encoder n_embs] and [B, face encoder
        n_embs], each unless ``given`` holds it (then it is returned as
        given); none when ``given`` says ``encode`` is false.
        parallel/sharding.py draws them once for the global batch."""
        if not given.get("encode", True):
            return {}
        noise, face_noise = given.get("noise"), given.get("face_noise")
        if noise is None:
            noise = torch.randn((batch_size, self.encoder.n_embs),
                                generator=self.generator).to(device)
        if face_noise is None:
            face_noise = torch.randn((batch_size, self.encoder_face.encoder.n_embs),
                                     generator=self.generator).to(device)
        return {"noise": noise, "face_noise": face_noise}

    def forward(
        self,
        pose: torch.Tensor,
        campos: torch.Tensor,
        registration_vertices: Optional[torch.Tensor] = None,
        ambient_occlusion: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        Rt: Optional[torch.Tensor] = None,
        camera_idx: Optional[torch.Tensor] = None,
        embs: Optional[torch.Tensor] = None,
        face_embs: Optional[torch.Tensor] = None,
        iteration: Optional[torch.Tensor] = None,
        encode: bool = True,
        train: bool = False,
        noise: Optional[torch.Tensor] = None,
        face_noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """With ``train=True`` the encoders' noise ([B, encoder n_embs] and
        [B, face encoder n_embs]) is drawn from the model's generator unless
        ``noise`` / ``face_noise`` give it."""
        enc_preds: Dict[str, torch.Tensor] = {}
        if encode:
            if train:
                drawn = self.training_draws(
                    pose.shape[0], pose.device,
                    {"noise": noise, "face_noise": face_noise})
                noise, face_noise = drawn["noise"], drawn["face_noise"]
            else:
                noise = face_noise = None
            verts_unposed = self.lbs_fn.unpose(registration_vertices,
                                               pose).detach()
            verts_unposed_uv = self.geo_fn.to_uv(verts_unposed).detach()
            enc_preds = {**self.encoder(verts_unposed_uv, noise),
                         **self.encoder_face(verts_unposed_uv, face_noise)}
            embs = enc_preds["embs"]
            face_embs = enc_preds["face_embs"]
        return self.decode(pose, campos, ambient_occlusion, K, Rt,
                           camera_idx, embs, face_embs, enc_preds, train)

    def decode(self, pose, campos, ambient_occlusion, K, Rt, camera_idx,
               embs, face_embs, enc_preds, train) -> Dict[str, Any]:
        """Latents -> geometry, texture, shadow and the render: everything
        after the encoders (``enc_preds`` joins the predictions)."""
        dec_preds = self.decoder(pose, embs, face_embs)
        geom_rec = self.lbs_fn.pose(dec_preds["geom_delta_rec"], pose)
        dec_view_preds = self.decoder_view(geom_rec, dec_preds["tex_mean_rec"],
                                           campos)
        shadow_preds = self.shadow_net(ambient_occlusion)
        if self.pose_to_shadow is not None:
            # training distills ShadowUNet's map into PoseToShadow; eval
            # takes the distilled net's map
            p2s_map = self.pose_to_shadow(pose)["shadow_map"]
            key = "pose_shadow_map" if train else "shadow_map"
            shadow_preds = {**shadow_preds, key: p2s_map}

        tex_mean_rec = dec_preds["tex_mean_rec"]
        tex_view_rec = dec_view_preds["tex_view_rec"]
        x = torch.cat([tex_mean_rec, tex_view_rec], dim=1)
        tex_rec = tex_mean_rec + tex_view_rec
        tex_rec = self.seam_sampler.impaint(tex_rec)
        tex_rec = self.seam_sampler.resample(tex_rec)
        T2 = self.tex_size
        tex_rec = interpolate_bilinear(tex_rec, size=(T2, T2))
        tex_rec = tex_rec + self.upscale_net(x)
        tex_rec = tex_rec * self.tex_std + self.tex_mean
        shadow_map = shadow_preds["shadow_map"]
        shadow_map = self.seam_sampler_2k.impaint(shadow_map)
        shadow_map = self.seam_sampler_2k.resample(shadow_map)
        shadow_map = self.seam_sampler_2k.resample(shadow_map)
        tex_rec = tex_rec * shadow_map
        tex_rec = self.seam_sampler_2k.impaint(tex_rec)
        tex_rec = self.seam_sampler_2k.resample(tex_rec)
        tex_rec = self.seam_sampler_2k.resample(tex_rec)
        if self.cal is not None and camera_idx is not None:
            tex_rec = self.cal(tex_rec, camera_idx)

        preds: Dict[str, Any] = {
            "geom": geom_rec,
            "tex_rec": tex_rec,
            **dec_preds,
            **shadow_preds,
            **dec_view_preds,
            **enc_preds,
        }
        if self.renderer is not None and K is not None:
            renders = self.renderer(
                geom_rec, torch.cat([tex_rec, torch.ones_like(tex_rec[:, :1])],
                                    dim=1), K, Rt)
            depth = renders["depth_img"][:, None].detach()
            preds.update(rgb=renders["render"][:, :3],
                         alpha=renders["render"][:, 3:], depth=depth,
                         depth_disc_mask=depth_discontinuity_mask(depth))
        if self.learn_blur is not None and camera_idx is not None:
            preds["rgb"] = self.learn_blur(preds["rgb"], camera_idx)
            preds["learn_blur_weights"] = self.learn_blur.reg(camera_idx)
        if self.pixel_cal is not None and camera_idx is not None:
            preds["rgb"] = preds["rgb"] + self.pixel_cal(camera_idx)
        return preds


def _default_masks(assets: Any, uv_size: int, init_uv_size: int,
                   n_pose_local: int) -> Dict[str, np.ndarray]:
    """Fetch (or synthesize) the conditioning masks from assets."""
    def get(name, default):
        try:
            return np.asarray(assets[name], np.float32)
        except (KeyError, AttributeError):
            logger.warning(f"assets missing {name}; using default")
            return default

    face_mask = get("face_mask", np.zeros((uv_size, uv_size), np.float32))
    pose_cond = get("pose_cond_mask", np.ones(
        (1, n_pose_local, init_uv_size, init_uv_size), np.float32))
    head_cond = get("head_cond_mask",
                    np.zeros((init_uv_size, init_uv_size), np.float32))
    if pose_cond.ndim == 3:
        pose_cond = pose_cond[None]
    pose_cond_mask = pose_cond * (
        1 - head_cond.reshape(1, 1, *head_cond.shape[-2:]))
    face_default = np.zeros((init_uv_size, init_uv_size), np.float32)
    face_default[init_uv_size // 2:, : init_uv_size // 2] = 1.0
    face_cond = get("face_cond_mask", face_default)
    body_cond = get("body_cond_mask",
                    np.ones((init_uv_size, init_uv_size), np.float32))
    ao_mean = get("ambient_occlusion_mean", get(
        "ao_mean", np.full((1, uv_size, uv_size), 0.5, np.float32)))
    return {
        "face_mask": face_mask,
        "pose_cond_mask": pose_cond_mask.astype(np.float32),
        "face_cond_mask": face_cond,
        "body_cond_mask": body_cond,
        "ao_mean": ao_mean,
    }


def _identity_seam_data(uv_size: int) -> Dict[str, np.ndarray]:
    gy, gx = np.meshgrid(
        (np.arange(uv_size) + 0.5) / uv_size,
        (np.arange(uv_size) + 0.5) / uv_size, indexing="ij")
    return {
        "dst_ij": np.zeros((1, 2), np.int64),
        "src_ij": np.zeros((1, 2), np.int64),
        "uvs": np.stack([gx, gy], -1).astype(np.float32),
        "weights": np.zeros((1, 1, uv_size, uv_size), np.float32),
    }


class AutoEncoder(ModelFacade):
    """Facade: builds the UV tables, the skeleton, the seam samplers and the
    renderer once and the inner module on ``device``, its parameters drawn
    from ``generator`` (seed 0 when none is given)."""

    def __init__(
        self,
        encoder: Dict[str, Any],
        encoder_face: Dict[str, Any],
        decoder: Dict[str, Any],
        decoder_view: Dict[str, Any],
        shadow_net: Dict[str, Any],
        upscale_net: Dict[str, Any],
        assets: Any,
        pose_to_shadow: Optional[Dict[str, Any]] = None,
        renderer: Optional[Dict[str, Any]] = None,
        cal: Optional[Dict[str, Any]] = None,
        pixel_cal: Optional[Dict[str, Any]] = None,
        learn_blur: bool = True,
        uv_size: int = 1024,
        tex_size: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        self.device = dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.assets = assets
        self.cameras = [str(c) for c in assets.camera_ids]
        decoder = dict(decoder)
        uv_size = int(decoder.get("uv_size", uv_size))
        tex_size = tex_size or uv_size * 2
        topo = assets.topology

        self.geo_fn = GeometryModule(
            np.asarray(topo.vi), np.asarray(topo.vt), np.asarray(topo.vti),
            np.asarray(topo.v2uv), uv_size=uv_size, impaint=True, device=dev)
        template = np.asarray(
            assets.get("template_mesh", assets.get("template_mesh_unscaled")))
        if template.ndim == 2:
            template = template[None]
        global_scaling = np.asarray(
            assets.get("global_scaling", [1.0, 1.0, 1.0]), np.float32)
        self.lbs_fn = LBSModule(assets.lbs_model_json,
                                assets.lbs_config_dict, template,
                                assets.skeleton_scales, global_scaling,
                                device=dev)
        seam_1k = assets.get("seam_data_1024", None)
        seam_2k = assets.get("seam_data_2048", None)
        self.seam_sampler = SeamSampler(
            seam_1k if seam_1k is not None else _identity_seam_data(uv_size),
            device=dev)
        self.seam_sampler_2k = SeamSampler(
            seam_2k if seam_2k is not None else _identity_seam_data(tex_size),
            device=dev)

        tex_mean = gaussian_blur_np(
            np.asarray(assets.color_mean, np.float32)[None], 11)
        tex_mean = torch.from_numpy(tex_mean).to(dev)
        if tex_mean.shape[-1] != tex_size:
            tex_mean = interpolate_bilinear(tex_mean,
                                            size=(tex_size, tex_size))
        self.tex_std = float(assets.get("tex_var", 64.0))

        init_uv_size = int(decoder.get("init_uv_size", 64))
        decoder["uv_size"] = uv_size
        masks = _default_masks(assets, uv_size, init_uv_size,
                               int(decoder["n_pose_dims"]))

        rl = None
        if renderer is not None:
            rl_keys = ("tile_size", "max_tiles_per_face",
                       "max_faces_per_tile", "chunk", "pair_budget_mult",
                       "z_near")
            rl = RenderLayer(
                h=int(renderer["image_height"]),
                w=int(renderer["image_width"]), vi=self.geo_fn.vi_np,
                vt=self.geo_fn.vt_np, vti=self.geo_fn.vti_np, flip_uvs=False,
                device=dev,
                **{k: v for k, v in renderer.items() if k in rl_keys})

        cal_cfg = None
        if cal is not None:
            cal_cfg = dict(cal)
            cal_cfg["identity_camera"] = str(cal_cfg["identity_camera"])
        self.cal_enabled = cal is not None
        self.learn_blur_enabled = bool(learn_blur)
        self.pose_to_shadow_enabled = pose_to_shadow is not None
        self.pixel_cal_enabled = pixel_cal is not None
        self.module = self._net(
            geo_fn=self.geo_fn, lbs_fn=self.lbs_fn,
            seam_sampler=self.seam_sampler,
            seam_sampler_2k=self.seam_sampler_2k, renderer=rl,
            tex_mean=tex_mean, tex_std=self.tex_std, masks=masks,
            camera_ids=tuple(self.cameras), encoder_cfg=dict(encoder),
            encoder_face_cfg=dict(encoder_face), decoder_cfg=decoder,
            decoder_view_cfg=dict(decoder_view),
            shadow_net_cfg=dict(shadow_net),
            upscale_net_cfg=dict(upscale_net),
            pose_to_shadow_cfg=(dict(pose_to_shadow) if pose_to_shadow
                                else None),
            cal_cfg=cal_cfg,
            pixel_cal_cfg=dict(pixel_cal) if pixel_cal else None,
            learn_blur_enabled=self.learn_blur_enabled, uv_size=uv_size,
            tex_size=tex_size, generator=generator,
        ).to(dev)
        self.module.eval()

    def _net(self, **kw) -> nn.Module:
        """The inner module, from the shared precompute ``kw``."""
        return _MeshVAENet(**kw)

    def name_to_idx(self, camera_ids) -> torch.Tensor:
        return torch.tensor([self.cameras.index(str(c)) for c in camera_ids],
                            dtype=torch.int32, device=self.device)


class MeshVAESummary:
    """Host-side images for the training log (port of the JAX package's
    MeshVAESummary): the render and the ground truth through the display
    curve, and the normals of the rendered depth, as [B, 3, H, W] arrays
    in [0, 1]."""

    def __call__(self, preds: Dict[str, Any], batch: Dict[str, Any]
                 ) -> Dict[str, np.ndarray]:
        from goliath_torch.utils.geom import depth2normals
        from goliath_torch.utils.image import linear2display

        def host(x):
            return x.detach().float().cpu().numpy()

        out = {"render": np.clip(host(linear2display(
            preds["rgb"][:, :3])) / 255.0, 0, 1)}
        if "image" in batch:
            out["gt"] = np.clip(host(linear2display(batch["image"])) / 255.0,
                                0, 1)
        if "depth" in preds and "focal" in batch:
            mask = host(preds["depth"]) > 0
            n = host(depth2normals(preds["depth"], batch["focal"],
                                   batch["princpt"]))
            out["normals"] = np.clip((1.0 - n) / 2.0 * mask, 0, 1)
        return out
