"""MVP hands: pose-driven volumetric primitives (port of the JAX package's
models/hand_mvp.py; reference ca_code/models/hand_mvp.py).

A PoseEncoder tiles the local pose into an (n_prim_x)^2 feature map. The
GeomDecoder poses the LBS template (detached), takes each primitive's base
position from a barycentric sample of the UV grid and its base rotation
from the face's TBN frame, and decodes per-prim deltas of position,
rotation and scale and an alpha slab of uv^2 x z. The RGBSlabDecoder
decodes the RGB slab from the features, a view-cosine UV map and the
ambient occlusion. The slab is cut into K = (uv / primsize)^2 RGBA voxel
boxes that the MVP raymarcher renders (``utils/render_raymarcher.py``).

Submodules and parameters carry the flax names (``poseencoder``,
``geomdecoder.transdecoder.dec0``, ``geomdecoder.alphadecoder.tex_out``,
``rgbdecoder.texdecoder.tex0``, ``cal``, ``learn_blur``), so
``goliath_torch.convert.params_from_jax`` maps the JAX parameters one to
one. ``.detach()`` stands where the JAX package has ``stop_gradient``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from goliath_torch.models.base import ModelFacade
from goliath_torch.models.mesh_vae import _buffer
from goliath_torch.nn.blocks import ConvBlock, tile2d
from goliath_torch.nn.color_cal import CalV5
from goliath_torch.nn.dof_cal import LearnableBlur
from goliath_torch.nn.layers import (Conv2dWNUB, ConvTranspose2dWNUB,
                                     leaky_relu)
from goliath_torch.ops.backend import resolve_device
from goliath_torch.ops.raygen import compute_raydirs, make_pixelcoords
from goliath_torch.utils.geom import (
    GeometryModule,
    compute_tbn,
    compute_view_cos,
    index_image_impaint,
    make_postex,
    make_uv_barys,
    values_to_uv,
)
from goliath_torch.utils.image import linear2display, relu
from goliath_torch.utils.lbs import LBSModule
from goliath_torch.utils.quaternion import axisangle_to_matrix
from goliath_torch.utils.render_raymarcher import Raymarcher
from goliath_torch.utils.sampling import interpolate_bilinear


def init_primitives(slab_size: int, n_prims: int, geo_fn: GeometryModule):
    """Strided samples of the impainted UV face-index and barycentric
    images: each prim's vertex indices, texcoord indices and barycentric
    weights, [n, n, 3] numpy arrays (reference hand_mvp.py:50-68)."""
    stride = slab_size // int(n_prims ** 0.5)
    face_index, bary = make_uv_barys(geo_fn.vt_np, geo_fn.vti_np, slab_size,
                                     flip_uv=False)
    face_index, bary = index_image_impaint(face_index, bary)
    sl = slice(stride // 2, None, stride)
    prim_bary_img = bary[sl, sl]
    prim_vidx_img = geo_fn.vi_np[face_index[sl, sl]]
    prim_vtidx_img = geo_fn.vti_np[face_index[sl, sl]]
    return prim_vidx_img, prim_vtidx_img, prim_bary_img


class PoseEncoder(nn.Module):
    """Local pose -> (n_prim_x)^2 feature map (reference :269-294)."""

    def __init__(self, n_pose_dims: int, n_embs: int, in_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_size = in_size
        self.local_pose_conv_block = ConvBlock(
            n_pose_dims, 16, in_size, kernel_size=1, padding=0,
            generator=generator)
        self.joint_conv_block = ConvBlock(16, n_embs, in_size,
                                          generator=generator)

    def forward(self, pose: torch.Tensor) -> torch.Tensor:
        pose_tile = tile2d(pose[:, 6:], self.in_size)
        return self.joint_conv_block(self.local_pose_conv_block(pose_tile))


class TransDecoder(nn.Module):
    """Per-prim deltas of position, rotation vector and scale (reference
    :297-321)."""

    def __init__(self, inch: int, size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = [(inch, 64), (64, 128), (128, 64), (64, 64)]
        for i, (cin, cout) in enumerate(chans):
            self.add_module(f"dec{i}", Conv2dWNUB(cin, cout, size, size, 3, 1,
                                                  1, generator=generator))
        self.dec_out = Conv2dWNUB(64, 9, size, size, 3, 1, 1, alpha=1.0,
                                  generator=generator)

    def forward(self, local_encoding: torch.Tensor):
        h = local_encoding
        for i in range(4):
            h = leaky_relu(getattr(self, f"dec{i}")(h), 0.2)
        h = self.dec_out(h)
        out = h.reshape(h.shape[0], 9, -1).transpose(1, 2)
        primposdelta = out[:, :, 0:3] * 1.0e-4
        primrvecdelta = out[:, :, 3:6] * 0.01
        primscaledelta = torch.exp(0.01 * out[:, :, 6:9])
        return primposdelta, primrvecdelta, primscaledelta


class DeconvContentDecoder(nn.Module):
    """(n_prim_x)^2 features -> uv_size^2 slab of primsize_z * outch
    channels (reference :324-348)."""

    def __init__(self, primsize_z: int, inch: int, outch: int, in_size: int,
                 uv_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        n_ups = int(math.log2(uv_size // in_size))
        widths = [32, 32, 16][-max(n_ups - 1, 0):] if n_ups > 1 else []
        self.n_layers = len(widths)
        cin, size = inch, in_size
        for i, w in enumerate(widths):
            size *= 2
            self.add_module(f"tex{i}", ConvTranspose2dWNUB(
                cin, w, size, size, 4, 2, 1, generator=generator))
            cin = w
        self.tex_out = ConvTranspose2dWNUB(
            cin, primsize_z * outch, uv_size, uv_size, 4, 2, 1, alpha=1.0,
            generator=generator)

    def forward(self, local_enc: torch.Tensor) -> torch.Tensor:
        h = local_enc
        for i in range(self.n_layers):
            h = leaky_relu(getattr(self, f"tex{i}")(h), 0.2)
        return self.tex_out(h)


def prim_bases(geom_lbs: torch.Tensor, vt: torch.Tensor,
               vidx: torch.Tensor, vtidx: torch.Tensor, bary: torch.Tensor):
    """Base positions [B, K, 3] and base rotations [B, K, 3, 3] (columns
    tangent, bitangent, normal) of the prims on the posed mesh, and the
    mask [B, K] of the frames that fell back to the identity.

    Uncovered or collapsed UV texels give zero or singular TBN frames:
    zero-volume prims whose AABB the tiled march never bins, while y = 0
    marks all their samples as inside. Every frame with |det| < 0.5 is
    replaced by the identity (orthonormal frames have |det| = 1). A NaN
    frame (a face of zero UV area) fails the test and stays NaN, as in
    the JAX package."""
    B = geom_lbs.shape[0]
    primposbase = make_postex(geom_lbs, vidx, bary)
    primposbase = primposbase.permute(0, 2, 3, 1).reshape(B, -1, 3)
    tbn = compute_tbn(geom_lbs, vt, vidx, vtidx)
    primrotbase = torch.stack(tbn, dim=-2).reshape(B, -1, 3, 3) \
        .transpose(2, 3)
    fallback = torch.linalg.det(primrotbase).abs() < 0.5
    primrotbase = torch.where(
        fallback[..., None, None],
        torch.eye(3, dtype=primrotbase.dtype, device=primrotbase.device),
        primrotbase)
    return primposbase, primrotbase, fallback


class GeomDecoder(nn.Module):
    """LBS-posed prim bases, decoded deltas and the alpha slab (reference
    :353-434)."""

    def __init__(self, inch: int, primsize_z: int, uv_size: int,
                 lbs_fn: LBSModule, geo_fn: GeometryModule,
                 prim_vidx_img: np.ndarray, prim_vtidx_img: np.ndarray,
                 prim_bary_img: np.ndarray, in_size: int,
                 primposstart: int = 1000, prim_scale: float = 512.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lbs_fn, self.geo_fn = lbs_fn, geo_fn
        self.primsize_z, self.uv_size = primsize_z, uv_size
        self.primposstart, self.prim_scale = primposstart, prim_scale
        self.register_buffer("vidx", torch.from_numpy(prim_vidx_img),
                             persistent=False)
        self.register_buffer("vtidx", torch.from_numpy(prim_vtidx_img),
                             persistent=False)
        _buffer(self, "bary", prim_bary_img)
        self.transdecoder = TransDecoder(inch, in_size, generator=generator)
        self.alphadecoder = DeconvContentDecoder(
            primsize_z, inch, 1, in_size, uv_size, generator=generator)

    def forward(self, pose: torch.Tensor, joint: torch.Tensor,
                iteration=None, train: bool = False) -> Dict[str, torch.Tensor]:
        B = pose.shape[0]
        zeros = pose.new_zeros(
            (B,) + tuple(self.lbs_fn.lbs_template_verts.shape[-2:]))
        geom_lbs = self.lbs_fn.pose(zeros, pose).detach()
        primposbase, primrotbase, _ = prim_bases(
            geom_lbs, self.geo_fn.vt, self.vidx, self.vtidx, self.bary)
        primposbase = primposbase.detach()
        primrotbase = primrotbase.detach()

        delta_pos, delta_rvec, delta_scale = self.transdecoder(joint)
        if train and iteration is not None:
            warm = (torch.as_tensor(iteration, device=pose.device)
                    >= self.primposstart).to(delta_pos.dtype)
            delta_pos = delta_pos * warm
            delta_rvec = delta_rvec * warm
            delta_scale = delta_scale * warm + (1.0 - warm)

        primpos = primposbase + torch.einsum("bkij,bkj->bki", primrotbase,
                                             delta_pos)
        primscale = self.prim_scale * delta_scale
        primrot = torch.einsum("bkij,bkjl->bkil", primrotbase,
                               axisangle_to_matrix(delta_rvec))
        alpha = self.alphadecoder(joint).reshape(
            B, self.primsize_z, 1, self.uv_size, self.uv_size)
        return {
            "primalpha": relu(alpha),
            "primpos": primpos,
            "primscale": primscale,
            "primrot": primrot,
            "geom_lbs": geom_lbs,
        }


class RGBSlabDecoder(nn.Module):
    """RGB slab conditioned on the view and the ambient occlusion
    (reference :451-474)."""

    def __init__(self, inch: int, primsize_z: int, uv_size: int,
                 in_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.primsize_z, self.uv_size, self.in_size = primsize_z, uv_size, \
            in_size
        self.texdecoder = DeconvContentDecoder(
            primsize_z, inch, 3, in_size, uv_size, generator=generator)

    def forward(self, view_cos_uv, joint, ambient_occlusion) -> torch.Tensor:
        B = joint.shape[0]
        ao_ds = interpolate_bilinear(ambient_occlusion,
                                     size=(self.in_size, self.in_size))
        view_cond = torch.cat([joint, view_cos_uv, ao_ds], dim=1)
        rgb = self.texdecoder(view_cond).reshape(
            B, self.primsize_z, 3, self.uv_size, self.uv_size)
        return relu(25.0 * rgb + 100.0)


class _HandMVPNet(nn.Module):
    """Inner module of the MVP hand AutoEncoder."""

    def __init__(self, geo_fn: GeometryModule, lbs_fn: LBSModule,
                 prim_tables, valid_prims: np.ndarray, camera_ids,
                 cal_cfg: Optional[Dict[str, Any]], learn_blur_enabled: bool,
                 image_height: int, image_width: int, uv_size: int,
                 primsize: Tuple[int, int, int], n_pose_dims: int,
                 n_embs: int, volradius: float, prim_scale: float,
                 raymarcher_cfg: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.geo_fn = geo_fn
        self.image_height, self.image_width = image_height, image_width
        self.uv_size, self.primsize = uv_size, primsize
        self.volradius = volradius
        self.n_prim_x = uv_size // primsize[0]
        self.n_prim_y = uv_size // primsize[1]
        vidx, vtidx, bary = prim_tables
        self.register_buffer("prim_vidx", torch.from_numpy(vidx),
                             persistent=False)
        _buffer(self, "prim_bary", bary)
        _buffer(self, "valid_prims", valid_prims)   # as float32 0 / 1
        self.raymarcher = Raymarcher(volradius=volradius, **raymarcher_cfg)

        self.poseencoder = PoseEncoder(n_pose_dims, n_embs, self.n_prim_x,
                                       generator=g)
        self.geomdecoder = GeomDecoder(
            n_embs, primsize[2], uv_size, lbs_fn, geo_fn, vidx, vtidx, bary,
            in_size=self.n_prim_x, prim_scale=prim_scale, generator=g)
        self.build_appearance(n_pose_dims, n_embs, g)
        self.cal = (CalV5(cameras=camera_ids, **cal_cfg)
                    if cal_cfg is not None else None)
        self.learn_blur = (LearnableBlur(cameras=camera_ids)
                           if learn_blur_enabled else None)

    def build_appearance(self, n_pose_dims: int, n_embs: int,
                         generator: Optional[torch.Generator]) -> None:
        """The decoders of the prims' colour (the OLAT teacher builds its
        relight path here)."""
        self.rgbdecoder = RGBSlabDecoder(n_embs + 2, self.primsize[2],
                                         self.uv_size, self.n_prim_x,
                                         generator=generator)

    def forward(
        self,
        pose: torch.Tensor,
        campos: torch.Tensor,
        ambient_occlusion: Optional[torch.Tensor] = None,
        K: Optional[torch.Tensor] = None,
        Rt: Optional[torch.Tensor] = None,
        camera_idx: Optional[torch.Tensor] = None,
        background: Optional[torch.Tensor] = None,
        iteration: Optional[torch.Tensor] = None,
        train: bool = False,
    ) -> Dict[str, Any]:
        joint = self.poseencoder(pose)
        geo_preds = self.geomdecoder(pose, joint, iteration, train)
        geom_lbs = geo_preds["geom_lbs"]

        view_cos = compute_view_cos(geom_lbs, self.geo_fn.vi, campos)
        view_cos_uv = values_to_uv(view_cos[..., None], self.prim_vidx,
                                   self.prim_bary)
        primrgb = self.rgbdecoder(view_cos_uv, joint, ambient_occlusion)
        preds: Dict[str, Any] = {"primrgb": primrgb, **geo_preds}
        return self.render(preds, K, Rt, camera_idx, background, train)

    def render(self, preds: Dict[str, Any], K: torch.Tensor,
               Rt: torch.Tensor, camera_idx: Optional[torch.Tensor],
               background: Optional[torch.Tensor], train: bool
               ) -> Dict[str, Any]:
        """March the RGBA boxes of ``preds`` (its primrgb slab and the
        geometry) for the cameras K, Rt; then the colour calibration, the
        background (in training) and the blur. Adds rgb, alpha,
        mvp_window_overflow (and learn_blur_weights) to ``preds``."""
        B = preds["primpos"].shape[0]
        dev = preds["primpos"].device
        # slab -> [B, K, 4, z, py, px] channel-first voxel boxes
        pz, py_, px_ = self.primsize[2], self.primsize[1], self.primsize[0]
        rgba = torch.cat([preds["primrgb"], preds["primalpha"]], dim=2)
        rgba = rgba.reshape(B, pz, 4, self.n_prim_y, py_, self.n_prim_x, px_)
        primrgba = rgba.permute(0, 3, 5, 2, 1, 4, 6).reshape(
            B, self.n_prim_x * self.n_prim_y, 4, pz, py_, px_)

        # rays
        focal = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)
        princpt = K[:, :2, 2]
        camrot = Rt[:, :3, :3]
        campos_r = -torch.einsum("bji,bj->bi", camrot, Rt[:, :3, 3])
        pix = make_pixelcoords(B, self.image_height, self.image_width,
                               device=dev)
        raypos, raydir, tminmax = compute_raydirs(
            campos_r, camrot, focal, princpt, pix, self.volradius)

        decout = {
            "primpos": preds["primpos"],
            "primrot": preds["primrot"],
            "primscale": preds["primscale"],
            "primrgba": primrgba,
            "valid_prims": self.valid_prims,
        }
        rgb, alpha, _, _ = self.raymarcher(raypos, raydir, tminmax, decout,
                                           K, Rt)
        # the share of prims whose span outgrew the sampling window
        preds["mvp_window_overflow"] = self.raymarcher.window_overflow(decout)

        if self.cal is not None and camera_idx is not None:
            rgb = self.cal(rgb, camera_idx)
        if train and background is not None:
            rgb = rgb + (1.0 - alpha) * background[:, :3]
        preds.update(rgb=rgb, alpha=alpha)

        if self.learn_blur is not None and camera_idx is not None:
            preds["rgb"] = self.learn_blur(preds["rgb"], camera_idx)
            preds["learn_blur_weights"] = self.learn_blur.reg(camera_idx)
        return preds


class AutoEncoder(ModelFacade):
    """Facade: builds the UV tables, the skeleton and the prims' base
    tables once and the inner module on ``device``, its parameters drawn
    from ``generator`` (seed 0 when none is given). The raymarcher takes
    ``dt`` 1, ``max_steps`` 128, ``max_prims_per_tile`` 64 and ``chunk``
    16 unless ``raymarcher`` says otherwise, as in the JAX package."""

    net_class = _HandMVPNet

    def __init__(
        self,
        assets: Any,
        image_height: int,
        image_width: int,
        cal: Optional[Dict[str, Any]] = None,
        n_pose_dims: int = 54,
        n_embs: int = 64,
        volradius: float = 2000.0,
        primsize: Tuple[int, int, int] = (16, 16, 8),
        learn_blur: bool = True,
        uv_size: int = 1024,
        prim_scale: float = 512.0,
        global_scaling: float = 10.0,  # meter -> cm like the reference
        raymarcher: Optional[Dict[str, Any]] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        self.device = dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.assets = assets
        self.cameras = [str(c) for c in assets.camera_ids]
        primsize = tuple(primsize)
        n_prim_x = uv_size // primsize[0]
        n_prim_y = uv_size // primsize[1]
        topo = assets.topology

        self.lbs_fn = LBSModule(
            assets.lbs_model_json, assets.lbs_config_dict,
            np.asarray(assets.template_mesh_unscaled)[None],
            assets.skeleton_scales, [global_scaling] * 3, device=dev)
        self.geo_fn = GeometryModule(
            np.asarray(topo.vi), np.asarray(topo.vt), np.asarray(topo.vti),
            np.asarray(topo.v2uv), uv_size=uv_size, flip_uv=False,
            impaint=False, device=dev)
        prim_tables = init_primitives(uv_size, n_prim_x * n_prim_y,
                                      self.geo_fn)

        # a prim is valid where any texel of its UV block is covered
        vm = (self.geo_fn.index_image_np[..., 0] != -1).astype(np.float32)
        vm = vm.reshape(n_prim_y, uv_size // n_prim_y, n_prim_x,
                        uv_size // n_prim_x).mean(axis=(1, 3))
        valid_prims = (vm != 0).reshape(-1)

        cal_cfg = None
        if cal is not None:
            cal_cfg = dict(cal)
            cal_cfg["identity_camera"] = str(cal_cfg["identity_camera"])
        self.cal_enabled = cal is not None
        self.learn_blur_enabled = bool(learn_blur)

        rm_cfg = {"dt": 1.0, "max_steps": 128, "max_prims_per_tile": 64,
                  "chunk": 16}
        rm_cfg.update(raymarcher or {})

        self.module = self.net_class(
            geo_fn=self.geo_fn, lbs_fn=self.lbs_fn, prim_tables=prim_tables,
            valid_prims=valid_prims, camera_ids=tuple(self.cameras),
            cal_cfg=cal_cfg, learn_blur_enabled=self.learn_blur_enabled,
            image_height=image_height, image_width=image_width,
            uv_size=uv_size, primsize=primsize, n_pose_dims=n_pose_dims,
            n_embs=n_embs, volradius=float(volradius),
            prim_scale=float(prim_scale), raymarcher_cfg=rm_cfg,
            generator=generator,
        ).to(dev)
        self.module.eval()

    def name_to_idx(self, camera_ids) -> torch.Tensor:
        return torch.tensor([self.cameras.index(str(c)) for c in camera_ids],
                            dtype=torch.int32, device=self.device)


class HandMVPSummary:
    """Host-side images for the training log: the render, the alpha and
    the ground truth as [B, 3, H, W] arrays in [0, 1] (reference
    hand_mvp.py:483-559)."""

    def __call__(self, preds: Dict[str, Any], batch: Dict[str, Any]
                 ) -> Dict[str, np.ndarray]:
        def host(x):
            return x.detach().float().cpu().numpy()

        diag = {
            "render": np.clip(host(linear2display(preds["rgb"])) / 255.0,
                              0, 1),
            "alpha": np.clip(np.repeat(host(preds["alpha"]), 3, axis=1), 0,
                             1),
        }
        if "image" in batch:
            diag["gt"] = np.clip(host(linear2display(batch["image"]))
                                 / 255.0, 0, 1)
        return diag
