"""Synthetic capture fixture: a textured UV-sphere in a camera ring (port of
the JAX package's data/synthetic.py).

Generates static assets (topology, verts mean/var, color mean, camera ids,
neighbour tables, and the body-model assets of the mesh path: a 3-joint
momentum skeleton from ``make_synthetic_lbs``, the unscaled template mesh,
skeleton scales, the AO mean and the floor pose) and per-(frame, camera)
samples with the keys the head and body datasets yield (``pose`` and
``ambient_occlusion`` for the body models). Every array comes from numpy
``RandomState`` draws in the JAX package's order, so both packages see the
same data for the same seed.

``render_targets=True`` gives targets a model can fit: a fixed sinusoid
texture as ``color_mean`` / ``tex_mean`` and every sample's ``color``, and
``image`` / ``image_mask`` rendered from it through the mesh rasterizer
(``ops/rasterizer.py``, K5 and K4 on the card), lambert-shaded by the
frame's active lights. The frame's draws are then seeded per frame, so the
views of a frame agree. The targets are rendered once per dataset, on
``device``, and kept as numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device
from goliath_torch.ops.rasterizer import RenderLayer, interpolate
from goliath_torch.utils.assets import AttrDict
from goliath_torch.utils.geom import (
    compute_neighbours,
    compute_v2uv,
    vert_normals,
)


def make_sphere_mesh(n_lat: int = 8, n_lon: int = 12, radius: float = 100.0):
    """UV sphere with a rectangular UV atlas; returns (v, vi, vt, vti)."""
    verts = []
    uvs = []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2 * np.pi * j / n_lon
            verts.append([
                radius * np.sin(theta) * np.cos(phi),
                radius * np.cos(theta),
                radius * np.sin(theta) * np.sin(phi),
            ])
            uvs.append([
                0.05 + 0.9 * j / n_lon,
                0.05 + 0.9 * i / n_lat,
            ])
    v = np.asarray(verts, np.float32)
    vt = np.asarray(uvs, np.float32)
    faces = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            faces.append([a, c, b])
            faces.append([b, c, d])
    vi = np.asarray(faces, np.int64)
    return v, vi, vt, vi.copy()


def make_camera_ring(n_cams: int, img_h: int, img_w: int,
                     dist: float = 400.0, focal: float | None = None):
    """Cameras on a ring looking at the origin; returns (K, Rt, campos)."""
    if focal is None:
        focal = 1.2 * max(img_h, img_w)
    Ks, Rts, poss = [], [], []
    for c in range(n_cams):
        ang = 2 * np.pi * c / n_cams
        pos = np.asarray(
            [dist * np.sin(ang), 0.3 * dist * np.sin(2 * ang),
             dist * np.cos(ang)], np.float32
        )
        fwd = -pos / np.linalg.norm(pos)
        up = np.asarray([0, 1, 0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd])  # world->cam rows
        t = -R @ pos
        Rt = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)
        K = np.asarray(
            [[focal, 0, img_w / 2], [0, focal, img_h / 2], [0, 0, 1]],
            np.float32,
        )
        Ks.append(K)
        Rts.append(Rt)
        poss.append(pos)
    return np.stack(Ks), np.stack(Rts), np.stack(poss)


def make_synthetic_lbs(v: np.ndarray, vi: np.ndarray, vt: np.ndarray,
                       vti: np.ndarray, n_joints: int = 3):
    """Tiny momentum-format skeleton: a chain of joints along +y with
    nearest-2-joint linear skinning. Returns (model_json, lbs_config_dict)
    for ``goliath_torch.utils.lbs``."""
    ys = np.linspace(v[:, 1].min(), v[:, 1].max(), n_joints)
    bones = []
    for j in range(n_joints):
        bones.append({
            "Name": f"joint{j}",
            "Parent": j - 1 if j > 0 else 2**30,  # root parent out of range
            "PreRotation": [0.0, 0.0, 0.0, 1.0],
            "TranslationOffset": [
                0.0, float(ys[j] - (ys[j - 1] if j > 0 else 0.0)), 0.0
            ],
        })

    # skin weights: blend between the two nearest chain joints by y
    weights_flat: List = []
    offsets = [0]
    for vert in v:
        y = vert[1]
        j = int(np.clip(np.searchsorted(ys, y) - 1, 0, n_joints - 2))
        t = (y - ys[j]) / max(ys[j + 1] - ys[j], 1e-6)
        t = float(np.clip(t, 0.0, 1.0))
        weights_flat.append((j, 1.0 - t))
        weights_flat.append((j + 1, t))
        offsets.append(len(weights_flat))

    model_json = {
        "Skeleton": {"Bones": bones},
        "SkinnedModel": {
            "RestPositions": v.tolist(),
            "RestVertexNormals": np.zeros_like(v).tolist(),
            "SkinningWeights": weights_flat,
            "SkinningOffsets": offsets,
            "Faces": {
                "Indices": np.asarray(vi).reshape(-1).tolist(),
                "TextureIndices": np.asarray(vti).reshape(-1).tolist(),
            },
            "TextureCoordinates": np.asarray(vt).reshape(-1).tolist(),
        },
    }

    # params: [root tx ty tz rx ry rz | per-child-joint rx ry rz | scales(J)]
    n_pose = 6 + 3 * (n_joints - 1)
    n_params = n_pose + n_joints
    transform = np.zeros((7 * n_joints, n_params), np.float32)
    for c in range(6):  # root tx..rz
        transform[c, c] = 1.0
    for j in range(1, n_joints):
        for c in range(3):  # child rx..rz
            transform[j * 7 + 3 + c, 6 + 3 * (j - 1) + c] = 1.0
    for j in range(n_joints):  # per-joint scale channels
        transform[j * 7 + 6, n_pose + j] = 1.0

    lbs_config_dict = {
        "channel_names": ["tx", "ty", "tz", "rx", "ry", "rz", "sc"],
        "transform": transform,
        "transform_offsets": np.zeros((1, 7 * n_joints), np.float32),
        "limits": [],
        "nr_scaling_params": n_joints,
        "nr_position_params": n_pose,
    }
    return model_json, lbs_config_dict


class SyntheticDataset:
    """Map-style dataset of capture-shaped samples (numpy)."""

    def __init__(
        self,
        n_cams: int = 4,
        n_frames: int = 8,
        img_h: int = 64,
        img_w: int = 64,
        uv_size: int = 64,
        n_lat: int = 8,
        n_lon: int = 12,
        n_lights: int = 5,
        n_pose_dims: int = 6,
        seed: int = 0,
        render_targets: bool = False,
        device: torch.device | str = "cuda",
    ):
        self.rng = np.random.RandomState(seed)
        self.img_h, self.img_w = img_h, img_w
        self.uv_size = uv_size
        self.n_frames = n_frames
        self.n_lights_max = n_lights
        self.render_targets = render_targets
        self.device = device   # where the targets are rendered
        self._targets = None   # {(frame, cam): (image, mask)}, numpy

        v, vi, vt, vti = make_sphere_mesh(n_lat, n_lon)
        self.v, self.vi, self.vt, self.vti = v, vi, vt, vti
        K, Rt, campos = make_camera_ring(n_cams, img_h, img_w)
        self.K, self.Rt, self.campos = K, Rt, campos
        self.camera_ids = [f"40{i:04d}" for i in range(n_cams)]

        nbs_idxs, nbs_weights = compute_neighbours(len(v), vi)
        if render_targets:
            uu, vv = np.meshgrid(
                np.linspace(0, 4 * np.pi, uv_size),
                np.linspace(0, 4 * np.pi, uv_size))
            color_mean = np.stack([
                127.5 + 100.0 * np.sin(uu) * np.cos(vv),
                127.5 + 100.0 * np.sin(uu + 1.3),
                127.5 + 100.0 * np.cos(vv + 0.7),
            ]).astype(np.float32)
        else:
            color_mean = (
                self.rng.rand(3, uv_size, uv_size).astype(np.float32) * 128
                + 64)
        self._fixed_tex = color_mean
        n_joints = 3
        lbs_model_json, lbs_config_dict = make_synthetic_lbs(
            v, vi, vt, vti, n_joints)
        self.n_pose_total = 6 + 3 * (n_joints - 1)
        self.static_assets = AttrDict({
            "topology": {
                "v": v, "vi": vi, "vt": vt, "vti": vti,
                "v2uv": compute_v2uv(len(v), vi, vti),
                "nbs_idxs": nbs_idxs, "nbs_weights": nbs_weights,
            },
            "verts_mean": v,
            "verts_var": float(v.var()),
            "color_mean": color_mean,
            "camera_ids": self.camera_ids,
            "n_pose_dims": n_pose_dims,
            "lbs_model_json": lbs_model_json,
            "lbs_config_dict": lbs_config_dict,
            "template_mesh_unscaled": v,
            "skeleton_scales": np.zeros((1, n_joints), np.float32),
            "ao_mean": np.full((1, uv_size, uv_size), 0.5, np.float32),
            "tex_mean": color_mean,
            "tex_var": 64.0**2,
            "floor_Rt": np.concatenate(
                [np.eye(3), np.zeros((3, 1))], 1).astype(np.float32),
        })

    def __len__(self) -> int:
        return self.n_frames * len(self.camera_ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        frame = idx % self.n_frames
        cam = idx // self.n_frames
        return self.get(frame, cam)

    @staticmethod
    def batch_filter(batch):
        return batch

    def _frame_state(self, frame: int, cam: int):
        """The frame's draws: seeded per frame with ``render_targets``,
        per (frame, camera) otherwise."""
        L = self.n_lights_max
        rng = np.random.RandomState(
            frame if self.render_targets else frame * 977 + cam)
        angle = 0.1 * np.sin(frame * 0.7)
        ca, sa = np.cos(angle), np.sin(angle)
        R_head = np.asarray(
            [[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32
        )
        head_pose = np.concatenate(
            [R_head, np.asarray([[0.0], [0.0], [0.0]], np.float32)], axis=1
        )
        verts = (self.v @ R_head.T).astype(np.float32)
        verts += rng.randn(*verts.shape).astype(np.float32) * 0.2
        light_pos = rng.randn(L, 3).astype(np.float32)
        light_pos = 500.0 * light_pos / np.linalg.norm(
            light_pos, axis=-1, keepdims=True
        )
        n_lights = 1 if frame % 3 == 0 else L
        light_intensity = np.ones((L, 1), np.float32) / n_lights
        return rng, head_pose, verts, light_pos, light_intensity, n_lights

    def _ensure_targets(self) -> None:
        """Render every (frame, camera) target once: the fixed texture
        through the UV atlas, times 0.25 + 0.75 x the lambert shade of the
        frame's active lights (interpolated from the vertices), clipped to
        [0, 1]."""
        if self._targets is not None:
            return
        dev = resolve_device(self.device)
        n_cams = len(self.camera_ids)
        rl = RenderLayer(self.img_h, self.img_w, self.vi, self.vt, self.vti,
                         device=dev)
        tex = torch.from_numpy(self._fixed_tex / 255.0).to(dev)
        tex = tex[None].expand(n_cams, -1, -1, -1)
        K = torch.from_numpy(self.K).to(dev)
        Rt = torch.from_numpy(self.Rt).to(dev)
        vi = rl.vi
        active = np.arange(self.n_lights_max)
        targets = {}
        with torch.no_grad():
            for frame in range(self.n_frames):
                _, _, verts, light_pos, light_int, n_lights = \
                    self._frame_state(frame, 0)
                light_w = torch.from_numpy(
                    (light_int[:, 0] * (active < n_lights))
                    .astype(np.float32)).to(dev)
                vb = torch.from_numpy(verts).to(dev)[None].expand(
                    n_cams, -1, -1)
                out = rl(vb, tex, K, Rt, edge_grad=False)
                n = vert_normals(vb, vi)                          # [B, V, 3]
                ldir = (torch.from_numpy(light_pos).to(dev)[None, :, None]
                        - vb[:, None])                            # [B, L, V, 3]
                ldir = ldir / torch.linalg.norm(ldir, dim=-1, keepdim=True)
                lam = (n[:, None] * ldir).sum(-1).clamp(min=0.0)  # [B, L, V]
                shade = (lam * light_w[None, :, None]).sum(1)     # [B, V]
                shade_img = torch.stack([
                    interpolate(s[:, None], vi, ii, bb)
                    for s, ii, bb in zip(shade, out["index_img"],
                                         out["bary_img"])])       # [B, 1, H, W]
                img = (out["render"] * (0.25 + 0.75 * shade_img)).clamp(
                    0.0, 1.0).cpu().numpy()
                mask = out["mask"].cpu().numpy()
                for cam in range(n_cams):
                    targets[(frame, cam)] = (img[cam], mask[cam])
        self._targets = targets

    def get(self, frame: int, cam: int) -> Dict[str, np.ndarray]:
        H, W = self.img_h, self.img_w
        T = self.uv_size
        rng, head_pose, verts, light_pos, light_intensity, n_lights = \
            self._frame_state(frame, cam)
        if self.render_targets:
            self._ensure_targets()
            image, mask = self._targets[(frame, cam)]
        else:
            image = rng.rand(3, H, W).astype(np.float32)
            mask = np.ones((1, H, W), np.float32)
        return {
            "head_pose": head_pose,
            "campos": self.campos[cam],
            "camera_idx": np.int32(cam),
            "camera_id": self.camera_ids[cam],
            "frame_id": np.int64(frame),
            "registration_vertices": verts,
            "color": (self._fixed_tex.copy() if self.render_targets
                      else rng.rand(3, T, T).astype(np.float32) * 255.0),
            "light_intensity": light_intensity,
            "light_pos": light_pos,
            "n_lights": np.int32(n_lights),
            "K": self.K[cam],
            "Rt": self.Rt[cam],
            "focal": self.K[cam][:2, :2],
            "princpt": self.K[cam][:2, 2],
            "image": image,
            "image_weight": np.ones((1, H, W), np.float32),
            "image_mask": mask,
            "background": np.zeros((3, H, W), np.float32),
            "is_fully_lit_frame": np.bool_(frame % 3 == 0),
            "pose": 0.1 * rng.randn(self.n_pose_total).astype(np.float32),
            "ambient_occlusion": rng.rand(1, T, T).astype(np.float32),
        }
