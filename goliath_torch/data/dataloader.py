"""Zip-backed multiview capture dataset (port of the JAX package's
data/dataloader.py; reference: ca_code/utils/dataloader.py).

One Dataset class serving the three Goliath capture types (BODY / HEAD /
HAND, dispatched from the capture directory name). Assets are read directly
out of per-camera zip files (avif images, png segmentations, ply
registrations, txt poses, json keypoints, per-frame light pattern, per-view
backgrounds), LRU-cached; the train/test split comes from
frame_splits_list.csv; fully-lit (light index 0) vs partially-lit (5-light
OLAT groups) frame filtering mirrors the reference. Zip members are read by
the native core (``goliath_torch/native``), or by Python ``zipfile`` where
it cannot be built; ``zipio`` logs which.

Everything is host-side numpy, bit for bit what the JAX package's dataset
yields (the harness moves batches to the device); shared ``.pt`` assets are
loaded with ``torch.load`` and converted to numpy. A sample with a missing
or unreadable asset is None, which ``collate`` drops.
"""

from __future__ import annotations

import json
import logging
import zipfile
from enum import Enum
from functools import lru_cache
from io import BytesIO
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

import torch

from goliath_torch.native import zipio
from goliath_torch.utils.assets import AttrDict
from goliath_torch.utils.hdr import resize_area
from goliath_torch.utils.ply import load_ply

logger = logging.getLogger(__name__)

CACHE_LENGTH = 160


class CaptureType(Enum):
    BODY = 1
    HEAD = 2
    HAND = 3


def get_capture_type(capture_name: str) -> CaptureType:
    if "Head" in capture_name:
        return CaptureType.HEAD
    if "Hand" in capture_name:
        return CaptureType.HAND
    if "Body" in capture_name:
        return CaptureType.BODY
    raise ValueError(f"cannot infer capture type from: {capture_name}")


def _pil_to_np(img) -> np.ndarray:
    """PIL image -> [C, H, W] uint8/uint16 numpy."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def _to_numpy(obj: Any) -> Any:
    """Recursively convert torch tensors in shared assets to numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


class BodyDataset:
    def __init__(
        self,
        root_path: str,
        shared_assets_path: str,
        split: str,
        fully_lit_only: bool = True,
        partially_lit_only: bool = False,
        cameras_subset: Optional[Iterable[str]] = None,
        frames_subset: Optional[Iterable[int]] = None,
        downsample: int = 2,
    ):
        if split not in {"train", "test"}:
            raise ValueError(f"invalid split {split}")
        self.root_path = Path(root_path)
        self.shared_assets_path = shared_assets_path
        self.split = split
        self.fully_lit_only = fully_lit_only
        self.partially_lit_only = partially_lit_only
        self.downsample = downsample

        self.capture_type = get_capture_type(self.root_path.name)
        self._get_fn: Callable = {
            CaptureType.BODY: self._get_for_body,
            CaptureType.HEAD: self._get_for_head,
            CaptureType.HAND: self._get_for_hand,
        }[self.capture_type]
        self._static_get_fn: Callable = {
            CaptureType.BODY: self._static_get_for_body,
            CaptureType.HEAD: self._static_get_for_head,
            CaptureType.HAND: self._static_get_for_hand,
        }[self.capture_type]

        self.cameras_subset = set(map(str, cameras_subset or {}))
        self.frames_subset = set(map(int, frames_subset or {}))
        self.cameras = list(self.get_camera_calibration().keys())

    # -- calibration / lists --------------------------------------------------

    @lru_cache(maxsize=1)
    def load_shared_assets(self) -> Dict[str, Any]:
        return _to_numpy(torch.load(self.shared_assets_path,
                                    map_location="cpu", weights_only=False))

    def asset_exists(self, frame: int) -> bool:
        if self.capture_type in (CaptureType.HEAD, CaptureType.HAND):
            return frame in self.get_frame_list(
                fully_lit_only=self.fully_lit_only)
        return True

    @lru_cache(maxsize=1)
    def get_camera_calibration(self) -> Dict[str, Any]:
        with open(self.root_path / "camera_calibration.json") as f:
            krt = json.load(f)["KRT"]
        params = {str(c["cameraId"]): c for c in krt}
        image_dir = self.root_path / "image"
        if image_dir.exists():
            zips = {p.name.split(".")[0][3:] for p in image_dir.iterdir()
                    if p.is_file()}
            params = {c: p for c, p in params.items() if c in zips}
        if self.cameras_subset:
            params = {c: p for c, p in params.items()
                      if c in self.cameras_subset}
        return params

    @lru_cache(maxsize=None)
    def get_camera_parameters(self, camera: str) -> Dict[str, Any]:
        krt = self.get_camera_calibration()[camera]
        ds = self.downsample
        K = np.asarray(krt["K"], np.float32).T
        K[:2, :2] /= ds
        K[:2, 2] = (K[:2, 2] + 0.5) / ds - 0.5
        Rt = np.asarray(krt["T"], np.float32).T[:3, :4]
        R, t = Rt[:3, :3], Rt[:3, 3]
        return {
            "Rt": Rt,
            "K": K,
            "campos": R.T @ (-t),
            "camrot": R,
            "focal": np.asarray(K[:2, :2], np.float32),
            "princpt": np.asarray(K[:2, 2], np.float32),
            "camera_idx": np.int32(self.cameras.index(camera)),
        }

    def get_camera_list(self) -> List[str]:
        return self.cameras

    def filter_frame_list(self, frames: List[int]) -> List[int]:
        if self.frames_subset:
            frames = sorted(set(frames) & self.frames_subset)
        return frames

    @lru_cache(maxsize=4)
    def get_frame_list(self, fully_lit_only: bool = False,
                       partially_lit_only: bool = False) -> List[int]:
        assert not (fully_lit_only and partially_lit_only)
        import csv

        with open(self.root_path / "frame_splits_list.csv") as f:
            rows = list(csv.DictReader(f))
        frame_list = [int(r["frame"]) for r in rows
                      if r["split"] == self.split]
        if (not (fully_lit_only or partially_lit_only)
                or self.capture_type is CaptureType.BODY):
            return self.filter_frame_list(frame_list)
        if fully_lit_only:
            fully = {f for f, idx in self.load_light_pattern() if idx == 0}
            return self.filter_frame_list([f for f in fully
                                           if f in frame_list])
        meta = self.load_light_pattern_meta()["light_patterns"]
        partial = {
            f for f, idx in self.load_light_pattern()
            if len(meta[idx]["light_index_durations"]) == 5
        }
        return self.filter_frame_list([f for f in partial
                                       if f in frame_list])

    # -- zip readers ----------------------------------------------------------

    def _zip_read(self, zip_rel: str, member: str) -> bytes:
        # native core: central directory parsed once per zip, pread and
        # inflate without the interpreter lock; Python zipfile where the
        # core cannot be built
        if zipio.have_native():
            return zipio.open_cached(self.root_path / zip_rel).read(member)
        with zipfile.ZipFile(self.root_path / zip_rel) as zf:
            with zf.open(member) as fh:
                return fh.read()

    def _zip_image(self, zip_rel: str, member: str) -> np.ndarray:
        from PIL import Image

        return _pil_to_np(Image.open(BytesIO(self._zip_read(zip_rel, member))))

    def load_image(self, frame: int, camera: str) -> np.ndarray:
        return self._zip_image(f"image/cam{camera}.zip",
                               f"cam{camera}/{frame:06d}.avif")

    def load_segmentation_parts(self, frame: int, camera: str):
        if not self.asset_exists(frame):
            return None
        return self._zip_image(f"segmentation_parts/cam{camera}.zip",
                               f"cam{camera}/{frame:06d}.png")

    def load_segmentation_fgbg(self, frame: int, camera: str):
        if not self.asset_exists(frame):
            return None
        return self._zip_image(f"segmentation_fgbg/cam{camera}.zip",
                               f"cam{camera}/{frame:06d}.png")

    @lru_cache(maxsize=CACHE_LENGTH)
    def load_3d_keypoints(self, frame: int):
        if not self.asset_exists(frame):
            return None
        return json.loads(self._zip_read("keypoints_3d/keypoints_3d.zip",
                                         f"{frame:06d}.json"))

    @lru_cache(maxsize=CACHE_LENGTH)
    def load_registration_vertices(self, frame: int):
        if not self.asset_exists(frame):
            return None
        raw = self._zip_read("kinematic_tracking/registration_vertices.zip",
                             f"registration_vertices/{frame:06d}.ply")
        verts, _ = load_ply(BytesIO(raw))
        return verts

    @lru_cache(maxsize=1)
    def load_registration_vertices_mean(self) -> np.ndarray:
        return np.load(self.root_path / "kinematic_tracking"
                       / "registration_vertices_mean.npy")

    @lru_cache(maxsize=1)
    def load_registration_vertices_variance(self) -> float:
        path = (self.root_path / "kinematic_tracking"
                / "registration_vertices_variance.txt")
        return float(path.read_text())

    @lru_cache(maxsize=CACHE_LENGTH)
    def load_pose(self, frame: int):
        if not self.asset_exists(frame):
            return None
        raw = self._zip_read("kinematic_tracking/pose.zip",
                             f"pose/{frame:06d}.txt")
        return np.asarray([float(x) for x in raw.decode().splitlines()],
                          np.float32)

    @lru_cache(maxsize=1)
    def load_template_mesh(self):
        verts, _ = load_ply(
            str(self.root_path / "kinematic_tracking" / "template_mesh.ply"))
        return verts

    @lru_cache(maxsize=1)
    def load_template_mesh_unscaled(self):
        verts, _ = load_ply(str(
            self.root_path / "kinematic_tracking" / "template_mesh_unscaled.ply"
        ))
        return verts

    @lru_cache(maxsize=1)
    def load_skeleton_scales(self) -> np.ndarray:
        path = self.root_path / "kinematic_tracking" / "skeleton_scales.txt"
        return np.asarray([float(x) for x in path.read_text().splitlines()],
                          np.float32)

    @lru_cache(maxsize=1)
    def load_floor_transforms(self) -> Dict[str, np.ndarray]:
        cam2gp = np.loadtxt(self.root_path / "floor_transformation.txt")
        cam2gp = np.vstack([cam2gp, [0, 0, 0, 1]])
        return {"floor_Rt": np.linalg.inv(cam2gp), "floor_Rt_inv": cam2gp}

    @lru_cache(maxsize=CACHE_LENGTH)
    def load_ambient_occlusion(self, frame: int):
        if not self.asset_exists(frame):
            return None
        return self._zip_image("uv_image/ambient_occlusion.zip",
                               f"ambient_occlusion/{frame:06d}.png")

    @lru_cache(maxsize=1)
    def load_ambient_occlusion_mean(self) -> np.ndarray:
        from PIL import Image

        return _pil_to_np(Image.open(
            self.root_path / "uv_image" / "ambient_occlusion_mean.png"))

    @lru_cache(maxsize=1)
    def load_color_mean(self):
        from PIL import Image

        path = self.root_path / "uv_image" / "color_mean.png"
        try:
            return _pil_to_np(Image.open(path))
        except Exception:
            logger.warning(f"could not load color mean at {path}")
            return None

    @lru_cache(maxsize=1)
    def load_color_variance(self) -> float:
        return float(
            (self.root_path / "uv_image" / "color_variance.txt").read_text())

    @lru_cache(maxsize=CACHE_LENGTH)
    def load_color(self, frame: int):
        if not self.asset_exists(frame):
            return None
        return self._zip_image("uv_image/color.zip",
                               f"color/{frame:06d}.png")

    @lru_cache(maxsize=CACHE_LENGTH)
    def load_head_pose(self, frame: int) -> np.ndarray:
        raw = self._zip_read("head_pose/head_pose.zip", f"{frame:06d}.txt")
        rows = [r.split() for r in raw.decode().splitlines()]
        return np.asarray([[float(x) for x in r] for r in rows], np.float32)

    @lru_cache(maxsize=CACHE_LENGTH)
    def load_background(self, camera: str) -> np.ndarray:
        return self._zip_image("per_view_background/per_view_background.zip",
                               f"{camera}.png")

    @lru_cache(maxsize=1)
    def load_light_pattern(self) -> List[Tuple[int, int]]:
        with open(self.root_path / "lights"
                  / "light_pattern_per_frame.json") as f:
            return [tuple(x) for x in json.load(f)]

    @lru_cache(maxsize=1)
    def load_light_pattern_meta(self) -> Dict[str, Any]:
        with open(self.root_path / "lights"
                  / "light_pattern_metadata.json") as f:
            return json.load(f)

    def _light_info(self, frame: int):
        pattern = dict(self.load_light_pattern())
        meta = self.load_light_pattern_meta()
        light_pos_all = np.asarray(meta["light_positions"], np.float32)
        n_all = light_pos_all.shape[0]
        info = np.asarray(
            meta["light_patterns"][pattern[frame]]["light_index_durations"],
            np.int64,
        )
        n_lights = info.shape[0]
        light_pos = np.zeros((n_all, 3), np.float32)
        light_intensity = np.zeros((n_all, 1), np.float32)
        light_pos[:n_lights] = light_pos_all[info[:, 0]]
        light_intensity[:n_lights] = info[:, 1:].astype(np.float32) / 5555.0
        return light_pos, light_intensity, n_lights

    # -- batch filters (reference :419-464) -----------------------------------

    @property
    def batch_filter(self) -> Callable:
        return {
            CaptureType.BODY: self._batch_filter_for_body,
            CaptureType.HEAD: self._batch_filter_for_head,
            CaptureType.HAND: self._batch_filter_for_hand,
        }[self.capture_type]

    @staticmethod
    def _black_level_wb(img: np.ndarray) -> np.ndarray:
        img = img.astype(np.float32)
        img[:, 0] = (img[:, 0] - 2) * 1.4
        img[:, 1] = (img[:, 1] - 1) * 1.1
        img[:, 2] = (img[:, 2] - 2) * 1.6
        return img

    def _batch_filter_for_body(self, batch):
        return batch

    def _batch_filter_for_head(self, batch):
        batch = dict(batch)
        batch["image"] = np.clip(
            self._black_level_wb(np.asarray(batch["image"])) / 255.0, 0, 1)
        if "background" in batch:
            batch["background"] = np.clip(
                self._black_level_wb(np.asarray(batch["background"])) / 255.0,
                0, 1)
        return batch

    def _batch_filter_for_hand(self, batch):
        batch = dict(batch)
        batch["image"] = np.clip(
            self._black_level_wb(np.asarray(batch["image"])), 0, 255.0)
        return batch

    # -- static assets ---------------------------------------------------------

    @property
    def static_assets(self) -> AttrDict:
        return AttrDict({**self.load_shared_assets(),
                         **self._static_get_fn()})

    def _static_get_for_body(self) -> Dict[str, Any]:
        return {
            "camera_ids": list(self.get_camera_calibration().keys()),
            "template_mesh": self.load_template_mesh(),
            "skeleton_scales": self.load_skeleton_scales(),
            "ambient_occlusion_mean":
                self.load_ambient_occlusion_mean() / 255.0,
            "color_mean": self.load_color_mean(),
            **self.load_floor_transforms(),
        }

    def _static_get_for_head(self) -> Dict[str, Any]:
        return {
            "camera_ids": list(self.get_camera_calibration().keys()),
            "verts_mean": self.load_registration_vertices_mean(),
            "verts_var": self.load_registration_vertices_variance(),
            "color_mean": self.load_color_mean(),
            "color_var": self.load_color_variance(),
            "light_pattern": self.load_light_pattern(),
            "light_pattern_meta": self.load_light_pattern_meta(),
        }

    def _static_get_for_hand(self) -> Dict[str, Any]:
        return {
            "camera_ids": list(self.get_camera_calibration().keys()),
            "template_mesh": self.load_template_mesh(),
            "skeleton_scales": self.load_skeleton_scales(),
            "template_mesh_unscaled": self.load_template_mesh_unscaled(),
            "ambient_occlusion_mean":
                self.load_ambient_occlusion_mean() / 255.0,
            "color_mean": self.load_color_mean(),
        }

    # -- per-sample get ---------------------------------------------------------

    def _get_for_body(self, frame: int, camera: str) -> Dict[str, Any]:
        seg_parts = self.load_segmentation_parts(frame, camera)
        ao = self.load_ambient_occlusion(frame)
        row = {
            "camera_id": camera,
            "frame_id": np.int64(frame),
            "image": self.load_image(frame, camera),
            "keypoints_3d": self.load_3d_keypoints(frame),
            "ambient_occlusion": None if ao is None else ao / 255.0,
            "registration_vertices": self.load_registration_vertices(frame),
            "segmentation_parts": seg_parts,
            "pose": self.load_pose(frame),
            "template_mesh": self.load_template_mesh(),
            "skeleton_scales": self.load_skeleton_scales(),
            "ambient_occlusion_mean": self.load_ambient_occlusion_mean(),
            "color_mean": self.load_color_mean(),
            "segmentation_fgbg":
                None if seg_parts is None
                else (seg_parts != 0).astype(np.float32),
            **self.get_camera_parameters(camera),
        }
        return row

    def _get_for_head(self, frame: int, camera: str) -> Dict[str, Any]:
        is_fully_lit = frame in self.get_frame_list(fully_lit_only=True)
        image = self.load_image(frame, camera)
        light_pos, light_intensity, n_lights = self._light_info(frame)
        seg = self.load_segmentation_parts(frame, camera)
        if seg is not None and seg.shape[-2] * 2 == image.shape[-2]:
            seg = np.repeat(np.repeat(seg, 2, axis=-2), 2, axis=-1)
        background = self.load_background(camera)[:3]
        if background.shape[-2:] != image.shape[-2:]:
            background = resize_area(
                background.transpose(1, 2, 0).astype(np.float32),
                image.shape[-2], image.shape[-1],
            ).transpose(2, 0, 1)
        row = {
            "camera_id": camera,
            "frame_id": np.int64(frame),
            "is_fully_lit_frame": np.bool_(is_fully_lit),
            "head_pose": self.load_head_pose(frame),
            "image": image,
            "registration_vertices": self.load_registration_vertices(frame),
            "light_pos": light_pos,
            "light_intensity": light_intensity,
            "n_lights": np.int32(n_lights),
            "color": self.load_color(frame),
            "background": background,
            "segmentation_parts": seg,
            "segmentation_fgbg":
                None if seg is None else (seg != 0).astype(np.float32),
            **self.get_camera_parameters(camera),
        }
        return row

    def _get_for_hand(self, frame: int, camera: str) -> Dict[str, Any]:
        is_fully_lit = frame in self.get_frame_list(fully_lit_only=True)
        image = self.load_image(frame, camera)
        light_pos, light_intensity, n_lights = self._light_info(frame)
        camera_parameters = self.get_camera_parameters(camera)
        if self.partially_lit_only:
            assert not is_fully_lit and n_lights == 5
            return {
                "camera_id": camera,
                "frame_id": np.int64(frame),
                "image": image,
                "pose": self.load_pose(frame),
                "light_pos": light_pos[:n_lights],
                "light_intensity": light_intensity[:n_lights],
                "n_lights": np.int32(n_lights),
                **camera_parameters,
            }
        seg = self.load_segmentation_fgbg(frame, camera)
        ao = self.load_ambient_occlusion(frame)
        return {
            "camera_id": camera,
            "frame_id": np.int64(frame),
            "is_fully_lit_frame": np.bool_(is_fully_lit),
            "image": image,
            "keypoints_3d": self.load_3d_keypoints(frame),
            "pose": self.load_pose(frame),
            "light_pos": light_pos,
            "light_intensity": light_intensity,
            "n_lights": np.int32(n_lights),
            "segmentation_fgbg":
                None if seg is None else (seg != 0).astype(np.float32),
            "ambient_occlusion": None if ao is None else ao[:1] / 255.0,
            **camera_parameters,
        }

    def get(self, frame: int, camera: str) -> Optional[Dict[str, Any]]:
        sample = self._get_fn(frame, camera)
        missing = [k for k, v in sample.items() if v is None]
        if missing:
            logger.warning(
                f"sample frame={frame} camera={camera} missing: {missing}")
            return None
        return sample

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        frame_list = self.get_frame_list(
            fully_lit_only=self.fully_lit_only,
            partially_lit_only=self.partially_lit_only,
        )
        camera_list = self.get_camera_list()
        frame = frame_list[idx // len(camera_list)]
        camera = camera_list[idx % len(camera_list)]
        try:
            return self.get(frame, camera)
        except Exception as e:  # noqa: BLE001 — any bad asset drops the sample
            logger.warning(
                f"error loading frame={frame} camera={camera}: {e}")
            return None

    def __len__(self) -> int:
        return len(self.get_frame_list(
            fully_lit_only=self.fully_lit_only,
            partially_lit_only=self.partially_lit_only,
        )) * len(self.get_camera_list())
