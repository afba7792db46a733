"""Writes fake Goliath captures (Head, Hands, Body) in the layout the
capture dataset (``data/dataloader.py`` of both packages) reads: per-camera
image and segmentation zips, the kinematic tracking, UV images, keypoints,
head poses, light patterns and per-view backgrounds, with the calibration
written at the full capture resolution (the dataset divides it by its
``downsample``). Used by the port's CPU tests and by ``chip_smoke.py``, so
both build captures the same way. Imports neither JAX nor the JAX package.

Images are PNG bytes stored under the ``.avif`` names (PIL reads by
content), of smooth seeded content (a coarse random grid resized
bilinearly) at a low ``compress_level``, so that full-size captures are
written in seconds. Every array comes from ``numpy.random.RandomState``
draws; ``CaptureSpec.missing`` leaves chosen members out, which the
dataset turns into dropped (None) samples.
"""

from __future__ import annotations

import json
import struct
import zipfile
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from io import BytesIO
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

STORED, DEFLATED = zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED
DOWNSAMPLE = 2          # BodyDataset's default downsample
COMPRESS_LEVEL = 1      # zlib level of every PNG
POSE_DIM = 12           # Hands, Body: entries of a frame's pose.txt


@dataclass
class CaptureSpec:
    """What a fake capture holds. ``K`` and ``Rt`` are the cameras of the
    stored images (after the dataset's downsampling); ``template`` is the
    mesh (Head: the registration mean; Hands and Body: the template PLYs,
    with ``faces``); the per-frame registrations (Head, Body) are the
    template plus seeded noise."""

    kind: str                                   # "Head", "Hands" or "Body"
    cameras: List[str]
    K: np.ndarray                               # [C, 3, 3]
    Rt: np.ndarray                              # [C, 3, 4]
    frames: List[int]
    template: np.ndarray                        # [V, 3]
    faces: Optional[np.ndarray] = None          # [F, 3]
    test_frames: Sequence[int] = ()             # the other frames train
    image_hw: Tuple[int, int] = (64, 64)
    uv_size: int = 32
    color_mean: Optional[np.ndarray] = None     # [3, T, T]; None: no file
    # light patterns as [[light index, duration], ...]; pattern 0 is the
    # fully-lit one, a 5-entry pattern an OLAT group
    light_patterns: Optional[List[List[List[int]]]] = None
    pattern_of_frame: Optional[Dict[int, int]] = None   # default: alternate
    n_light_positions: int = 8
    seg_half: bool = False         # Head: segmentation at half image size
    background_hw: Optional[Tuple[int, int]] = None     # Head
    missing: Sequence[Tuple[str, int, str]] = ()  # (zip dir, frame, camera)
    seed: int = 0


def png_bytes(arr: np.ndarray) -> bytes:
    """[C, H, W] (C = 1 or 3) or [H, W] uint8 -> PNG bytes, every row under
    the Up filter (smooth content leaves small differences, which zlib
    compresses fast; ``zlib.compress`` and the numpy work run outside the
    interpreter lock, so threads encode images at once)."""
    a = np.asarray(arr, np.uint8)
    if a.ndim == 3:
        a = a[0] if a.shape[0] == 1 else a.transpose(1, 2, 0)
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.empty((h, 1 + rows.shape[1]), np.uint8)
    raw[:, 0] = 2                                   # filter type Up
    raw[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=raw[1:, 1:])

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = 2 if a.ndim == 3 else 0                 # RGB or grey, 8 bits
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), COMPRESS_LEVEL))
            + chunk(b"IEND", b""))


def _grid(rng: np.random.RandomState, c: int, cells: int,
          levels: Optional[int]) -> np.ndarray:
    if levels is not None:
        return rng.randint(0, levels, (cells, cells)).astype(np.uint8)
    small = rng.randint(0, 256, (cells, cells, c)).astype(np.uint8)
    return small if c > 1 else small[..., 0]


def _resized(small: np.ndarray, h: int, w: int, nearest: bool
             ) -> np.ndarray:
    from PIL import Image

    out = np.asarray(Image.fromarray(small).resize(
        (w, h), Image.NEAREST if nearest else Image.BILINEAR))
    return out.transpose(2, 0, 1) if out.ndim == 3 else out[None]


def smooth_image(rng: np.random.RandomState, c: int, h: int, w: int,
                 cells: int = 6, levels: Optional[int] = None) -> np.ndarray:
    """[c, h, w] uint8: a cells x cells random grid resized to h x w
    (bilinear; nearest for label images with ``levels``)."""
    return _resized(_grid(rng, c, cells, levels), h, w, levels is not None)


def ply_bytes(verts: np.ndarray, faces: Optional[np.ndarray] = None) -> bytes:
    """Binary little-endian PLY, as the JAX package's ``save_ply`` writes."""
    hdr = [b"ply", b"format binary_little_endian 1.0",
           f"element vertex {len(verts)}".encode(),
           b"property float x", b"property float y", b"property float z"]
    if faces is not None:
        hdr += [f"element face {len(faces)}".encode(),
                b"property list uchar int vertex_indices"]
    hdr.append(b"end_header")
    out = [b"\n".join(hdr) + b"\n", np.asarray(verts, "<f4").tobytes()]
    if faces is not None:
        rows = np.zeros(len(faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
        rows["n"], rows["i"] = 3, np.asarray(faces)
        out.append(rows.tobytes())
    return b"".join(out)


def ring_pose(frame: int) -> np.ndarray:
    """The head's [3, 4] pose of a frame: a small turn about y."""
    a = 0.1 * np.sin(frame * 0.7)
    ca, sa = np.cos(a), np.sin(a)
    R = np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
    return np.concatenate([R, np.zeros((3, 1), np.float32)], 1)


class _Zips:
    """Members per zip file, written at the end; leaves out the members of
    ``missing`` ((zip dir, frame, camera); camera None for per-frame
    zips). ``image`` encodes an array as PNG on the thread pool."""

    def __init__(self, root: Path, missing, pool: ThreadPoolExecutor):
        self.root, self.missing = root, set(missing)
        self.pool = pool
        self.members: Dict[str, List[Tuple[str, object, int]]] = {}

    def add(self, rel: str, member: str, data, kind: int = STORED,
            key: Optional[Tuple[str, int, Optional[str]]] = None):
        if key is not None and key in self.missing:
            return
        self.members.setdefault(rel, []).append((member, data, kind))

    def image(self, rel: str, member: str, arr: np.ndarray, key=None):
        if key not in self.missing:
            self.add(rel, member,
                     self.pool.submit(png_bytes, arr))

    def smooth(self, rel: str, member: str, rng: np.random.RandomState,
               c: int, h: int, w: int, levels: Optional[int] = None,
               key=None):
        """A ``smooth_image``: its grid drawn now (missing or not, so that
        the later draws do not move), resized and encoded on the pool."""
        small = _grid(rng, c, 6, levels)
        if key not in self.missing:
            self.add(rel, member, self.pool.submit(
                lambda: png_bytes(_resized(small, h, w,
                                           levels is not None))))

    def write(self):
        for rel, members in self.members.items():
            path = self.root / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            with zipfile.ZipFile(path, "w") as zf:
                for name, data, kind in members:
                    if isinstance(data, Future):
                        data = data.result()
                    zf.writestr(zipfile.ZipInfo(name), data,
                                compress_type=kind)


def calibration(spec: CaptureSpec) -> dict:
    """camera_calibration.json: K and the 4x4 extrinsics, transposed, at
    the full resolution (``DOWNSAMPLE`` x the stored images')."""
    ds, krt = DOWNSAMPLE, []
    for cam, K, Rt in zip(spec.cameras, spec.K, spec.Rt):
        Kf = np.asarray(K, np.float64).copy()
        Kf[:2, :2] *= ds
        Kf[:2, 2] = (Kf[:2, 2] + 0.5) * ds - 0.5
        T = np.eye(4)
        T[:3] = Rt
        krt.append({"cameraId": cam, "K": Kf.T.tolist(), "T": T.T.tolist()})
    return {"KRT": krt}


def write_capture(capture_root: Path, name: str, spec: CaptureSpec) -> Path:
    """Write the capture ``capture_root / name`` (``name`` names the kind,
    as Goliath's directories do) and return its path."""
    if spec.kind not in name:
        raise ValueError(f"{name} does not name a {spec.kind} capture")
    root = Path(capture_root) / name
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(spec.seed)
    with ThreadPoolExecutor(max_workers=8) as pool:
        _write(root, spec, rng, _Zips(root, spec.missing, pool))
    return root


def _write(root: Path, spec: CaptureSpec, rng: np.random.RandomState,
           zips: "_Zips") -> None:
    H, W = spec.image_hw
    T = spec.uv_size
    head, hand, body = (spec.kind == k for k in ("Head", "Hands", "Body"))

    (root / "camera_calibration.json").write_text(json.dumps(
        calibration(spec)))
    with open(root / "frame_splits_list.csv", "w") as f:
        f.write("frame,split\n")
        for fr in spec.frames:
            f.write(f"{fr},{'test' if fr in spec.test_frames else 'train'}\n")

    seg_dir = "segmentation_fgbg" if hand else "segmentation_parts"
    sh, sw = (H // 2, W // 2) if spec.seg_half else (H, W)
    for cam in spec.cameras:
        for fr in spec.frames:
            zips.smooth(f"image/cam{cam}.zip", f"cam{cam}/{fr:06d}.avif",
                        rng, 3, H, W, key=("image", fr, cam))
            zips.smooth(f"{seg_dir}/cam{cam}.zip", f"cam{cam}/{fr:06d}.png",
                        rng, 1, sh, sw, levels=4, key=(seg_dir, fr, cam))

    kt = root / "kinematic_tracking"
    kt.mkdir(exist_ok=True)
    v = np.asarray(spec.template, np.float32)
    if head or body:
        for fr in spec.frames:
            verts = v + 0.2 * rng.randn(*v.shape).astype(np.float32)
            zips.add("kinematic_tracking/registration_vertices.zip",
                     f"registration_vertices/{fr:06d}.ply",
                     ply_bytes(verts), DEFLATED,
                     key=("registration_vertices", fr, None))
    if head:
        np.save(kt / "registration_vertices_mean.npy", v)
        (kt / "registration_vertices_variance.txt").write_text(
            repr(float(v.var())))
    else:
        for fname in ("template_mesh.ply", "template_mesh_unscaled.ply"):
            (kt / fname).write_bytes(ply_bytes(v, spec.faces))
        (kt / "skeleton_scales.txt").write_text("\n".join(["0.0"] * 3))
        for fr in spec.frames:
            pose = 0.1 * rng.randn(POSE_DIM).astype(np.float32)
            zips.add("kinematic_tracking/pose.zip", f"pose/{fr:06d}.txt",
                     "\n".join(repr(float(p)) for p in pose).encode(),
                     DEFLATED, key=("pose", fr, None))
            kps = np.round(rng.randn(8, 4), 4).tolist()
            zips.add("keypoints_3d/keypoints_3d.zip", f"{fr:06d}.json",
                     json.dumps({"frame": fr, "keypoints": kps}).encode(),
                     DEFLATED, key=("keypoints_3d", fr, None))

    uv = root / "uv_image"
    uv.mkdir(exist_ok=True)
    if spec.color_mean is not None:
        (uv / "color_mean.png").write_bytes(png_bytes(
            np.clip(np.rint(spec.color_mean), 0, 255)))
    if head:
        (uv / "color_variance.txt").write_text("64.0")
        base = (spec.color_mean if spec.color_mean is not None
                else np.full((3, T, T), 128.0))
        for fr in spec.frames:
            color = np.clip(np.rint(base + 8.0 * rng.randn(3, T, T)), 0, 255)
            zips.image("uv_image/color.zip", f"color/{fr:06d}.png", color,
                       key=("color", fr, None))
        for fr in spec.frames:
            pose = ring_pose(fr)
            zips.add("head_pose/head_pose.zip", f"{fr:06d}.txt", "\n".join(
                " ".join(repr(float(x)) for x in row) for row in pose
            ).encode(), DEFLATED, key=("head_pose", fr, None))
        bh, bw = spec.background_hw or (H, W)
        for cam in spec.cameras:
            zips.smooth("per_view_background/per_view_background.zip",
                        f"{cam}.png", rng, 3, bh, bw,
                        key=("per_view_background", None, cam))
    else:
        (uv / "ambient_occlusion_mean.png").write_bytes(png_bytes(
            smooth_image(rng, 1, T, T)))
        for fr in spec.frames:
            zips.smooth("uv_image/ambient_occlusion.zip",
                        f"ambient_occlusion/{fr:06d}.png", rng, 1, T, T,
                        key=("ambient_occlusion", fr, None))
    if body:
        floor = np.eye(4)[:3]
        floor[:, 3] = rng.randn(3)
        np.savetxt(root / "floor_transformation.txt", floor)

    if head or hand:
        lights = root / "lights"
        lights.mkdir(exist_ok=True)
        patterns = spec.light_patterns or [
            [[0, 5555]], [[i, 5555] for i in range(1, 6)]]
        of_frame = spec.pattern_of_frame or {
            fr: i % 2 for i, fr in enumerate(spec.frames)}
        with open(lights / "light_pattern_per_frame.json", "w") as f:
            json.dump([[fr, of_frame[fr]] for fr in spec.frames], f)
        pos = rng.randn(spec.n_light_positions, 3)
        pos = 1000.0 * pos / np.linalg.norm(pos, axis=-1, keepdims=True)
        with open(lights / "light_pattern_metadata.json", "w") as f:
            json.dump({"light_positions": pos.tolist(), "light_patterns": [
                {"light_index_durations": p} for p in patterns]}, f)
    zips.write()


def write_shared_assets(path: Path, assets: dict) -> Path:
    """``torch.save`` of ``assets`` with numpy arrays as tensors, as the
    capture's shared ``static_assets_*.pt`` holds them."""
    import torch

    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return x

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(conv(dict(assets)), path)
    return path
