"""Drivable mesh-VAE body (port of the JAX package's
models/mesh_vae_drivable.py).

The mesh_vae variant keyed on ``lbs_motion`` / ``geom`` / ``ao``: the body
latent comes from the LBS-unposed geometry (``Encoder``), the face latent
from a frozen, pretrained ``FaceDecoderFrontal`` that decodes an external
face code ``face_embs`` into face geometry and a frontal texture, which the
mugsy-masked ``FaceEncoder`` encodes again. Everything after the encoders
(ConvDecoder, view decoder, shadow, upscale, seams, the render through
``ops/rasterizer.py`` with K4 and K5) is mesh_vae's
(``models/mesh_vae.py``).

The face decoder runs without a gradient, as the JAX module stops the
gradient at its outputs: its parameters take zero gradients in a training
step (``optim.ChainedOptimizer`` turns the missing ``.grad`` into zeros),
so Adam leaves them where they are.

``train=True`` draws the two encoders' noise from the model's generator
unless the batch gives ``noise`` / ``face_noise``. No dataset of either
package gives this model its inputs (``lbs_motion``, ``geom``, ``ao``,
``face_embs``): a caller renames the synthetic or capture keys and draws a
face code itself, as the JAX package's test of the model does.

Submodules carry the flax names (``encoder.verts_conv``,
``encoder_face.geommod``, ``decoder_face.texmod_up0``, ...), so
``goliath_torch.convert.params_from_jax`` maps the JAX parameters one to
one.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from goliath_torch.models import mesh_vae as mv
from goliath_torch.nn.blocks import ConvDownBlock
from goliath_torch.nn.face import FaceDecoderFrontal
from goliath_torch.nn.layers import LinearWN, leaky_relu
from goliath_torch.utils.geom import GeometryModule
from goliath_torch.utils.sampling import interpolate_bilinear

logger = logging.getLogger(__name__)


class Encoder(mv.Encoder):
    """Unposed-geometry encoder: mesh_vae's, without its mean and input
    scales (a ``verts_scale`` is refused, as the JAX module has no such
    field), taking the unposed vertices rather than their UV map."""

    def __init__(self, geo_fn: GeometryModule, n_embs: int, mask: Any,
                 enc_size: int = 512, noise_std: float = 1.0,
                 logvar_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        # a scale of 1.0 multiplies exactly: the JAX module's arithmetic
        super().__init__(n_embs, mask, enc_size, noise_std, mean_scale=1.0,
                         logvar_scale=logvar_scale, generator=generator)
        self.geo_fn = geo_fn

    def forward(self, motion: torch.Tensor, verts_unposed: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        return super().forward(self.geo_fn.to_uv(verts_unposed), noise)


class FaceEncoder(nn.Module):
    """Mugsy-masked encoder of the decoded face texture and geometry; every
    output key carries the ``face_`` prefix."""

    def __init__(self, n_embs: int, mugsy_mask: Any, n_vert_in: int,
                 uv_size: int = 512, noise_std: float = 1.0,
                 logvar_scale: float = 0.1, prefix: str = "face_",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, S = generator, uv_size
        self.n_embs, self.uv_size = n_embs, S
        self.noise_std, self.logvar_scale = noise_std, logvar_scale
        self.prefix = prefix
        mask = torch.from_numpy(np.array(mugsy_mask, np.float32)[None, None])
        self.register_buffer(
            "mask", interpolate_bilinear(mask, size=(S, S),
                                         align_corners=True),
            persistent=False)
        widths = [(3, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 128),
                  (128, 128)]
        widths = widths[-int(math.log2(S // 4)):]
        widths[0] = (3, widths[0][1])
        size = S
        for i, (cin, cout) in enumerate(widths):
            self.add_module(f"conv{i}", ConvDownBlock(cin, cout, size,
                                                      generator=g))
            size //= 2
        self.n_conv = len(widths)
        self.last = widths[-1][1]
        self.geommod = LinearWN(n_vert_in, 256, generator=g)
        self.jointmod = LinearWN(4 * 4 * self.last + 256, 512, generator=g)
        self.mu = LinearWN(512, n_embs, alpha=1.0, generator=g)
        self.logvar = LinearWN(512, n_embs, alpha=1.0, generator=g)

    def forward(self, face_geom: torch.Tensor, face_tex: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``noise`` [B, n_embs] (standard normal) turns the training
        reparameterization on, as in ``mesh_vae.Encoder``."""
        B, S = face_geom.shape[0], self.uv_size
        tex_cond = interpolate_bilinear(face_tex, size=(S, S))
        tex_cond = (tex_cond / 255.0 - 0.5) * self.mask
        x = tex_cond
        for i in range(self.n_conv):
            x = getattr(self, f"conv{i}")(x)
        tex_enc = x.reshape(B, 4 * 4 * self.last)
        geom_enc = leaky_relu(self.geommod(face_geom.reshape(B, -1)))
        x = leaky_relu(self.jointmod(torch.cat([tex_enc, geom_enc], dim=1)))
        embs_mu = self.mu(x)
        embs_logvar = self.logvar_scale * self.logvar(x)
        embs = embs_mu
        if noise is not None:
            embs = embs_mu + torch.exp(embs_logvar) * noise * self.noise_std
        preds = dict(embs=embs, embs_mu=embs_mu, embs_logvar=embs_logvar,
                     tex_cond=tex_cond)
        return {f"{self.prefix}{k}": v for k, v in preds.items()}


class _DrivableNet(mv._MeshVAENet):
    """Inner module: the drivable encoders and the frozen face decoder, then
    mesh_vae's decode."""

    def _make_encoders(self, encoder_cfg, encoder_face_cfg, masks, uv_size,
                       generator, mugsy_mask=None, face_assets=None,
                       decoder_face_cfg=None):
        g = generator
        self.encoder = Encoder(self.geo_fn, mask=1.0 - masks["face_mask"],
                               generator=g, **encoder_cfg)
        self.decoder_face = FaceDecoderFrontal(face_assets, generator=g,
                                               **decoder_face_cfg)
        self.encoder_face = FaceEncoder(mugsy_mask=mugsy_mask, generator=g,
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
            face_noise = torch.randn((batch_size, self.encoder_face.n_embs),
                                     generator=self.generator).to(device)
        return {"noise": noise, "face_noise": face_noise}

    def forward(
        self,
        lbs_motion: torch.Tensor,
        campos: torch.Tensor,
        geom: Optional[torch.Tensor] = None,
        ao: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        Rt: Optional[torch.Tensor] = None,
        camera_idx: Optional[torch.Tensor] = None,
        face_embs: Optional[torch.Tensor] = None,
        embs: Optional[torch.Tensor] = None,
        iteration: Optional[torch.Tensor] = None,
        encode: bool = True,
        train: bool = False,
        noise: Optional[torch.Tensor] = None,
        face_noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """``face_embs`` is the external face code the frozen decoder takes
        (with ``encode``) or the body-space face latent (without). With
        ``train=True`` the encoders' noise ([B, encoder n_embs] and [B,
        face encoder n_embs]) is drawn from the model's generator unless
        ``noise`` / ``face_noise`` give it."""
        enc_preds: Dict[str, Any] = {}
        if encode:
            if train:
                drawn = self.training_draws(
                    lbs_motion.shape[0], lbs_motion.device,
                    {"noise": noise, "face_noise": face_noise})
                noise, face_noise = drawn["noise"], drawn["face_noise"]
            else:
                noise = face_noise = None
            verts_unposed = self.lbs_fn.unpose(geom, lbs_motion).detach()
            enc_preds = self.encoder(lbs_motion, verts_unposed, noise)
            # the frozen pretrained face decoder on the external face code
            with torch.no_grad():
                face_dec_preds = self.decoder_face(face_embs)
            face_enc = self.encoder_face(face_dec_preds["face_geom"],
                                         face_dec_preds["face_tex"],
                                         face_noise)
            enc_preds = {**enc_preds, **face_enc,
                         "face_dec_preds": face_dec_preds}
            embs = enc_preds["embs"]
            face_embs = enc_preds["face_embs"]
        return self.decode(lbs_motion, campos, ao, K, Rt, camera_idx, embs,
                           face_embs, enc_preds, train)


class _FaceAssets:
    def __init__(self, face_frontal_view: np.ndarray):
        self.face_frontal_view = face_frontal_view


class AutoEncoder(mv.AutoEncoder):
    """Facade: mesh_vae's host-side precompute with the drivable net.
    ``uv_size`` also sizes the all-ones mugsy mask used when the assets
    have none (a warning says so); a missing ``face_frontal_view`` is
    zeros(3)."""

    def __init__(self, encoder, encoder_face, decoder_face, decoder,
                 decoder_view, shadow_net, upscale_net, assets,
                 pose_to_shadow=None, renderer=None, cal=None,
                 pixel_cal=None, learn_blur=True, uv_size=1024,
                 tex_size=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        mugsy = assets.get("mugsy_face_mask", None)
        if mugsy is None:
            logger.warning("assets missing mugsy_face_mask; using ones")
            mugsy = np.ones((uv_size, uv_size), np.float32)
        else:
            mugsy = np.asarray(mugsy, np.float32)
            if mugsy.ndim == 3:
                mugsy = mugsy[..., 0]
        self._face = dict(
            mugsy_mask=mugsy,
            face_assets=_FaceAssets(np.asarray(
                assets.get("face_frontal_view", np.zeros(3)), np.float32)),
            decoder_face_cfg=dict(decoder_face))
        super().__init__(
            encoder=encoder, encoder_face=encoder_face, decoder=decoder,
            decoder_view=decoder_view, shadow_net=shadow_net,
            upscale_net=upscale_net, assets=assets,
            pose_to_shadow=pose_to_shadow, renderer=renderer, cal=cal,
            pixel_cal=pixel_cal, learn_blur=learn_blur, uv_size=uv_size,
            tex_size=tex_size, device=device, generator=generator)

    def _net(self, **kw) -> nn.Module:
        return _DrivableNet(**kw, **self._face)


MeshVAESummary = mv.MeshVAESummary
