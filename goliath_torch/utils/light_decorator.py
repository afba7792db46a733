"""Eval-time light decorators (port of the JAX package's
utils/light_decorator.py).

``SingleLightCycleDecorator`` puts one point light on an orbit, a step a
frame index; ``EnvSpinDecorator`` loads an HDR envmap, builds its
SG-prefiltered specular mip levels once, rotates the map a step a frame and
turns its 16x32 texels into 512 point lights, the scaled mip levels and a
background. Both wrap a model facade: ``decorator.apply(batch, train=False)``
adds the light inputs to the batch and calls ``facade.apply``. Their tensors
are made on the facade's device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from goliath_torch.utils import envmap as envmap_lib
from goliath_torch.utils.hdr import load_envmap, resize_area
from goliath_torch.utils.quaternion import axisangle_to_matrix
from goliath_torch.utils.sampling import avg_pool2d, interpolate_bilinear

ENV_SIZE = (512, 1024)   # the envmap is resized to this (H, W) first
PREFILTER_SEED = 7


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _frame_index(data: Dict[str, Any], B: int) -> np.ndarray:
    return _host(data["index"]) if "index" in data else np.zeros(B)


class SingleLightCycleDecorator:
    """Orbiting point light: ``cycle`` frames a turn about the axis
    ``light_rotate_axis`` (0: x, 1: y at height 300, 2: z), 1100 units from
    the head (``head_pose``'s or ``pose``'s translation where the batch has
    one)."""

    def __init__(self, mod, cycle: int = 256, light_rotate_axis: int = 0):
        self.mod = mod
        self.cycle = cycle
        self.light_rotate_axis = light_rotate_axis

    def augment(self, data: Dict[str, Any]) -> Dict[str, Any]:
        B = data["campos"].shape[0]
        index = _frame_index(data, B)
        light_pos = []
        for i in range(B):
            trans = None
            if "head_pose" in data:
                trans = _host(data["head_pose"][i])[:3, 3]
            elif "pose" in data:
                trans = _host(data["pose"][i][:3])
            angle = (abs(float(index[i])) % self.cycle) / self.cycle * 2 * math.pi
            if self.light_rotate_axis == 0:
                lp = np.asarray([0.0, 1100 * math.sin(angle),
                                 1100 * math.cos(angle)], np.float32)
            elif self.light_rotate_axis == 1:
                lp = np.asarray([-1100 * math.sin(angle), 300.0,
                                 1100 * math.cos(angle)], np.float32)
            else:
                lp = np.asarray([1100 * math.cos(angle),
                                 1100 * math.sin(angle), 0.0], np.float32)
            lp = 1100.0 * lp / np.linalg.norm(lp)
            if trans is not None:
                lp = lp + trans
            light_pos.append(lp)
        dev = self.mod.device
        data = dict(data)
        data["light_intensity"] = torch.ones((B, 1, 1), device=dev)
        data["light_pos"] = torch.from_numpy(
            np.stack(light_pos)).to(dev)[:, None]
        data["n_lights"] = torch.ones((B,), dtype=torch.int32, device=dev)
        data["is_fully_lit_frame"] = torch.zeros((B,), dtype=torch.bool,
                                                 device=dev)
        return data

    def apply(self, batch: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        return self.mod.apply(self.augment(batch), **kwargs)


class EnvSpinDecorator:
    """HDRI-spin relighting: the envmap turns about y by 2 pi / ``cycle`` a
    frame index. The ``miplevel - 1`` prefiltered levels draw their
    uniforms from a generator seeded 7 unless ``draws`` gives them: per
    level, one [1, 2, H_i, W_i] tensor a sample (then ``prefilter_samples``
    is their count)."""

    def __init__(
        self,
        mod,
        envmap_path: str,
        envmap_dist: float = 10000.0,
        env_scale: float = 18.0,
        cycle: int = 256,
        sigma_step: float = 0.2,
        miplevel: int = 4,
        ydown: bool = False,
        prefilter_samples: int = 64,
        draws: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ):
        self.mod = mod
        self.envmap_dist = envmap_dist
        self.env_scale = env_scale
        self.cycle = cycle
        dev = mod.device
        generator = torch.Generator().manual_seed(PREFILTER_SEED)

        image = load_envmap(envmap_path)
        if ydown:
            image = image[::-1, ::-1]
        # float32 whichever branch resize_area takes (its bilinear one
        # gives float64)
        image = np.ascontiguousarray(
            resize_area(image, *ENV_SIZE).transpose(2, 0, 1), np.float32)
        # the background's scale: the unrotated map's 90th percentile (the
        # rotation resamples the same texels)
        self.perc90 = float(np.percentile(image, 90))
        self.image = torch.from_numpy(image).to(dev)   # [3, H, W]

        H = self.image.shape[1]
        multisin = torch.sin((torch.arange(H, device=dev) + 0.5)
                             * math.pi / H)[None, None, :, None]
        mipmap = [self.image[None]]
        img = self.image[None] * multisin
        for i in range(miplevel - 1):
            sigma = (i + 1) * sigma_step
            img = avg_pool2d(img, 2)
            h, w = img.shape[2:]
            theta, phi = torch.meshgrid(
                (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
                * math.pi / h,
                (torch.arange(-w // 2, w // 2, dtype=torch.float32,
                              device=dev) + 0.5) * 2 * math.pi / w,
                indexing="ij")
            vec = torch.stack(
                [torch.sin(theta) * torch.sin(phi), torch.cos(theta),
                 -torch.sin(theta) * torch.cos(phi)], 0)[None]
            mipmap.append(envmap_lib.prefilter_envmap_sg(
                sigma, vec, img, prefilter_samples, generator=generator,
                draws=None if draws is None else draws[i]))
        self._mipmap = mipmap

        L = 16
        theta, phi = np.meshgrid(
            (np.arange(L, dtype=np.float32) + 0.5) * np.pi / L,
            (np.arange(-L, L, dtype=np.float32) + 0.5) * np.pi / L,
            indexing="ij",
        )
        sphvec = np.stack(
            [np.sin(theta) * np.sin(phi), np.cos(theta),
             -np.sin(theta) * np.cos(phi)], 0).reshape(3, -1)
        self.n_env_lights = sphvec.shape[1]
        self._light_pos = self.envmap_dist * torch.from_numpy(
            np.ascontiguousarray(sphvec.T)).to(dev)
        self._sin_w = torch.sin((torch.arange(16, device=dev) + 0.5)
                                * math.pi / 16)[None, :, None]

    def augment(self, data: Dict[str, Any]) -> Dict[str, Any]:
        B = data["campos"].shape[0]
        index = _frame_index(data, B)
        dev = self.image.device
        lightrots, envbgs, envmaps, lints = [], [], [], []
        norm_scales = []
        for i in range(B):
            rot_y = 2.0 * math.pi * float(index[i]) / self.cycle
            rot_mat = axisangle_to_matrix(
                torch.tensor([0.0, rot_y, 0.0], dtype=torch.float32,
                             device=dev))
            new_env = envmap_lib.rotate_envmap_mat(self.image, rot_mat)
            lightrots.append(rot_mat)
            denom = self.perc90 if self.perc90 > 0 else new_env.max()
            envbgs.append(new_env / denom)

            small = interpolate_bilinear(new_env[None], size=(16, 32))[0]
            total = torch.sum(small * self._sin_w)
            small = self.env_scale * small / total
            norm_scales.append(self.env_scale / total)
            envmaps.append(small)
            lints.append(small.reshape(3, -1).T)

        data = dict(data)
        scale = 2.0 * math.pi * norm_scales[0]
        data["preconv_envmap"] = tuple(
            m.expand((B,) + m.shape[1:]) * scale for m in self._mipmap)
        data["envmap"] = torch.stack(envmaps)
        data["lightrot"] = torch.stack(lightrots)
        data["light_intensity"] = torch.stack(lints)
        data["light_pos"] = self._light_pos[None].repeat(B, 1, 1)
        data["envbg"] = torch.stack(envbgs)
        data["n_lights"] = torch.full((B,), self.n_env_lights,
                                      dtype=torch.int32, device=dev)
        data["is_fully_lit_frame"] = torch.zeros((B,), dtype=torch.bool,
                                                 device=dev)
        return data

    def apply(self, batch: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        return self.mod.apply(self.augment(batch), **kwargs)
