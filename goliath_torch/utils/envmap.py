"""Equirect environment-map ops (port of the JAX package's utils/envmap.py).

Rotation, camera-background projection, mirrorball rendering, SG
importance-sampled prefiltering and direction -> equirect-UV mapping, on
the port's ``grid_sample`` and ``interpolate_bilinear`` (the JAX package's
formulas term for term). The prefilter's uniforms come from an explicit
``torch.Generator`` or are passed in (``draws``), which is how a test feeds
both packages the same values.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from goliath_torch.utils.quaternion import axisangle_to_matrix
from goliath_torch.utils.sampling import (grid_sample, interpolate_bilinear,
                                          linspace)

_PI = math.pi
BLUR_TAPS = 101   # the background blur: 101x101 Gaussian over [-4, 4]^2


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1, keepdims=True)``: sqrt of the sum of
    squares."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _sphere_dirs(height: int, width: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Unit direction per equirect texel, [H, W, 3]; y is up."""
    theta = (torch.arange(height, dtype=torch.float32, device=device)
             + 0.5) * _PI / height
    phi = (torch.arange(-(width // 2), width - width // 2,
                        dtype=torch.float32, device=device)
           + 0.5) * 2.0 * _PI / width
    theta = theta[:, None]
    phi = phi[None, :]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack(
        [st * torch.sin(phi), ct.expand(height, width), st * torch.cos(phi)],
        dim=-1)


def dir2uv(d: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Direction -> equirect grid-sample coords in [-1, 1]^2."""
    d = torch.movedim(d, dim, -1)
    u = (1.0 / _PI) * torch.atan2(d[..., 0], d[..., 2])
    v = (1.0 / _PI) * torch.acos(d[..., 1].clamp(-1.0, 1.0))
    return torch.stack([u, 2.0 * v - 1.0], dim=-1)


def rotate_envmap_mat(image: torch.Tensor, rot_mat: torch.Tensor
                      ) -> torch.Tensor:
    """Rotate an envmap [3, H, W] by a rotation matrix (world-space)."""
    H, W = image.shape[1:]
    vec = _sphere_dirs(H, W, image.device)
    vec = (vec @ rot_mat).clamp(-1.0, 1.0)
    uv = dir2uv(vec, dim=-1)
    return grid_sample(image[None], uv[None], padding_mode="border")[0]


def rotate_envmap(image: torch.Tensor, rot_x: float = 0.0, rot_y: float = 0.0,
                  rot_z: float = 0.0) -> torch.Tensor:
    def mat(*r):
        return axisangle_to_matrix(torch.tensor(r, dtype=torch.float32,
                                                device=image.device))

    Rx, Ry, Rz = mat(rot_x, 0.0, 0.0), mat(0.0, rot_y, 0.0), mat(0.0, 0.0,
                                                                   rot_z)
    return rotate_envmap_mat(image, (Rz @ Ry @ Rx).T)


def blur_background(bg: torch.Tensor) -> torch.Tensor:
    """The 101x101 Gaussian blur of a camera background [B, 3, h, w]: a
    depthwise convolution with zero padding 50 (the JAX package's
    ``lax.conv_general_dilated`` with ``feature_group_count=3``), in its
    2-D form, which keeps the JAX package's terms."""
    k = torch.exp(-linspace(-4.0, 4.0, BLUR_TAPS, bg.device) ** 2)
    k2 = k[:, None] * k[None, :]
    kern = (k2 / k2.sum())[None, None].repeat(3, 1, 1, 1)
    return F.conv2d(bg, kern, padding=BLUR_TAPS // 2, groups=3)


def envmap_to_image(
    w: int, h: int, envbg: torch.Tensor, princpt: torch.Tensor,
    focal: torch.Tensor, camrot: Optional[torch.Tensor] = None,
    focal_scale: float = 0.2, blurbg: bool = True,
) -> torch.Tensor:
    """Project an envmap [B, 3, H', W'] to a camera background
    [B, 3, h, w]."""
    dev = envbg.device
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([px, py], -1)[None]
    raydir = pix - princpt[:, None, None, :]
    raydir = raydir / (
        torch.stack([focal[:, 0, 0], focal[:, 1, 1]], -1)[:, None, None]
        * focal_scale)
    raydir = torch.cat([raydir, torch.ones_like(raydir[..., :1])], dim=-1)
    if camrot is not None:
        raydir = torch.einsum("bxy,bhwx->bhwy", camrot, raydir)
    raydir = raydir / _norm(raydir)
    uv = dir2uv(raydir, dim=-1)
    bg = grid_sample(envbg, uv, padding_mode="border", align_corners=True)
    if blurbg:
        bg = interpolate_bilinear(blur_background(bg), size=(h, w))
    return bg


def envmap_to_mirrorball(w: int, h: int, env: torch.Tensor,
                         camrot: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Render an envmap as a mirrored ball inset: [B, 4, h, w] (rgb +
    mask)."""
    py, px = torch.meshgrid(linspace(-1.0, 1.0, h, env.device),
                            linspace(-1.0, 1.0, w, env.device),
                            indexing="ij")
    pix = torch.stack([px, py], -1)[None].expand(env.shape[0], h, w, 2)
    zsq = torch.sum(pix ** 2, -1, keepdim=True)
    mask = (zsq < 1.0).to(env.dtype)[:, None, :, :, 0]
    nz = -torch.sqrt((1.0 - zsq).clamp(min=0.0))
    nml = torch.cat([pix, nz], -1)
    ref = -2.0 * nz * nml
    ref = torch.cat([ref[..., :2], ref[..., 2:] + 1.0], -1)
    if camrot is not None:
        ref = torch.einsum("bxy,bhwx->bhwy", camrot, ref)
    uv = dir2uv(ref, dim=-1)
    ball = grid_sample(env, uv, padding_mode="border", align_corners=True)
    return torch.cat([ball, mask], dim=1)


def importance_sample_sg(Xi: torch.Tensor, n: torch.Tensor, sigma: float,
                         dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample a spherical Gaussian lobe around normals n.

    Xi: uniform randoms, 2 channels along ``dim``; n: unit vectors, 3
    channels. Returns (directions, pdf) with the channels along ``dim``.
    """
    Xi = torch.movedim(Xi, dim, -1)
    n_ = torch.movedim(n, dim, -1)
    phi = 2.0 * _PI * Xi[..., 0:1]
    sqrt2sigma = math.sqrt(2.0) * sigma
    theta_new = sqrt2sigma * torch.erfinv(
        Xi[..., 1:2] * math.erf(_PI / sqrt2sigma))
    cos_t, sin_t = torch.cos(theta_new), torch.sin(theta_new)
    Hv = torch.cat([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t],
                   dim=-1)
    pdf = (math.sqrt(2.0) * _PI ** (-0.5)
           / (sigma * math.erf(_PI / sqrt2sigma))
           * torch.exp(-0.5 * (theta_new / sigma) ** 2))
    m = (n_[..., 2:3] < 0.999).to(n_.dtype)
    up = torch.cat([1.0 - m, torch.zeros_like(m), m], dim=-1)
    tangent = torch.linalg.cross(up, n_, dim=-1)
    tangent = tangent / _norm(tangent).clamp(min=1e-12)
    bitangent = torch.linalg.cross(n_, tangent, dim=-1)
    sample = (tangent * Hv[..., 0:1] + bitangent * Hv[..., 1:2]
              + n_ * Hv[..., 2:3])
    sample = sample / _norm(sample).clamp(min=1e-12)
    return torch.movedim(sample, -1, dim), torch.movedim(pdf, -1, dim)


def sample_dirs(d: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Sample the equirect img [B, 3, H', W'] at directions d [B, 3, H, W]."""
    uv = dir2uv(d, 1)
    return grid_sample(img, uv, padding_mode="border", align_corners=False)


def prefilter_envmap_sg(
    sigma: float, v: torch.Tensor, env_tex: torch.Tensor,
    num_samples: int = 1, generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Monte-Carlo SG prefilter of an envmap along directions v [B, 3, H, W].

    Sample i's uniforms [B, 2, H, W] are ``draws[i]`` where given (then
    ``num_samples`` is their count), else drawn on the host from
    ``generator`` and moved to v's device."""
    if draws is None:
        draws = [torch.rand(v[:, :2].shape, generator=generator,
                            dtype=v.dtype) for _ in range(num_samples)]
    acc = torch.zeros_like(v)
    for x_i in draws:
        v_sample, _ = importance_sample_sg(x_i.to(v.device), v, sigma)
        acc = acc + sample_dirs(v_sample, env_tex)
    return acc / float(len(draws))


def compose_envmap(render: torch.Tensor, alpha: torch.Tensor,
                   envbg: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor
                   ) -> torch.Tensor:
    """Composite a render [B, 3, H, W] over the envmap background, with a
    mirrorball inset of min(200, H, W) pixels at the bottom right."""
    ms = min(200, render.shape[-1], render.shape[-2])
    env_mirror = envmap_to_mirrorball(ms, ms, envbg, Rt[:, :3, :3])
    mirror_img = torch.zeros_like(render)
    mirror_alpha = torch.zeros_like(alpha)
    mirror_alpha[:, :, -ms:, -ms:] = env_mirror[:, 3:]
    mirror_img[:, :, -ms:, -ms:] = env_mirror[:, :3]

    bg = envmap_to_image(render.shape[-1], render.shape[-2], envbg,
                         K[:, :2, 2], K, Rt[:, :3, :3])
    render = render + (1.0 - alpha) * bg.clamp(0.0, 1.0)
    return (1.0 - mirror_alpha) * render + mirror_alpha * mirror_img
