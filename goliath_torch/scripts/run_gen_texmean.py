"""Bake a capture's ``uv_image/color_mean.png`` by unprojecting frames into
UV (port of the JAX package's scripts/run_gen_texmean.py; reference:
ca_code/scripts/run_gen_texmean.py:28-108).

Averages the UV unprojection of the first ``texmean_num_frames`` (5) frames
of the split over all cameras, at ``texmean_uv_size`` (1024); required
before URHand training. Each (frame, camera) is one render through
``utils/tex.get_tex_rl`` (K5 once and K4 twice on the card); the per-view
textures and visibilities are accumulated in float32 numpy in the JAX
package's frame and camera order. Runs on the card unless ``device="cpu"``.
The JAX script also builds a ``GeometryModule`` whose UV tables it never
reads; the port takes the topology's index arrays directly.

The dataset is built from the config's ``data`` section with
``fully_lit_only`` set, as in the JAX package. A config that trains on
OLAT frames with ``partially_lit_only`` (``configs/urhand.yml``) gives no
view then, in both packages: its fully-lit frames fail the partially-lit
sample's check and its OLAT frames have no assets under
``fully_lit_only``, so the mean is all black. Pass
``data.partially_lit_only=false`` to average its fully-lit frames:

    python -m goliath_torch.scripts.run_gen_texmean configs/urhand.yml \
        capture_root=/path/to/goliath data.partially_lit_only=false
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from goliath_torch.config import Config, load_config
from goliath_torch.ops.backend import resolve_device
from goliath_torch.ops.rasterizer import RenderLayer
from goliath_torch.scripts.run_train import build_dataset
from goliath_torch.test import _save_png
from goliath_torch.utils.geom import (
    index_image_impaint,
    make_uv_barys,
    make_uv_vert_index,
)
from goliath_torch.utils.lbs import LBSModule
from goliath_torch.utils.tex import get_tex_rl

logger = logging.getLogger(__name__)


def main(config: Config, device: str = "cuda",
         view_seconds: Optional[List[float]] = None) -> Dict[str, Any]:
    """Write ``<data.root_path>/uv_image/color_mean.png``. Returns its path,
    the views rendered (frame, camera, texels it saw), the (frame, camera)
    pairs skipped and the share of UV texels that some view saw. With
    ``view_seconds`` given, appends each rendered view's wall time (its
    sample read, render and accumulation, ending when the texture reaches
    the host)."""
    device = resolve_device(device)
    data_cfg = dict(config.data)
    data_cfg["fully_lit_only"] = True
    dataset = build_dataset(data_cfg, device=device)
    assets = dataset.static_assets

    uv_size = int(config.get("texmean_uv_size", 1024))
    topo = assets.topology
    vi = np.asarray(topo.vi, np.int64)
    vt = np.asarray(topo.vt, np.float32)
    vti = np.asarray(topo.vti, np.int64)
    lbs_fn = LBSModule(
        assets.lbs_model_json, assets.lbs_config_dict,
        np.asarray(assets.template_mesh_unscaled)[None],
        assets.skeleton_scales,
        global_scaling=[config.get("global_scaling", 10.0)] * 3,
        device=device,
    )
    rl = RenderLayer(
        h=int(config.model.renderer.image_height),
        w=int(config.model.renderer.image_width),
        vi=vi, vt=vt, vti=vti, flip_uvs=False, device=device,
    )
    index_image = make_uv_vert_index(vt, vi, vti, uv_size=uv_size,
                                     flip_uv=True)
    face_index, bary_image = make_uv_barys(vt, vti, uv_size=uv_size,
                                           flip_uv=True)
    index_image, bary_image = index_image_impaint(index_image, bary_image)
    face_index = index_image_impaint(face_index)
    face_index = torch.from_numpy(face_index).to(device)
    index_image = torch.from_numpy(index_image).to(device)
    bary_image = torch.from_numpy(bary_image).to(device)

    num_frames = int(config.get("texmean_num_frames", 5))
    frame_list = dataset.get_frame_list()[:num_frames]
    camera_list = dataset.get_camera_list()

    tex_total = np.zeros((1, 3, uv_size, uv_size), np.float32)
    tex_cnt = np.zeros((1, 3, uv_size, uv_size), np.float32)
    rendered, skipped = [], []
    for fid in frame_list:
        for cid in camera_list:
            t0 = time.perf_counter()
            try:
                data = dataset.get(fid, cid)
            except Exception as e:  # noqa: BLE001 — a bad view is skipped
                logger.warning(f"failed loading cam {cid} frame {fid}: {e}")
                data = None
            if data is None:
                skipped.append((fid, cid))
                continue
            img = torch.from_numpy(np.asarray(data["image"], np.float32))[None].to(
                device)
            extrin = torch.as_tensor(data["Rt"])[None].to(device)
            intrin = torch.as_tensor(data["K"])[None].to(device)
            pose = torch.as_tensor(data["pose"])[None].to(device)
            with torch.no_grad():
                mesh_world = lbs_fn.pose(
                    torch.zeros((1,) + tuple(
                        lbs_fn.lbs_template_verts.shape[-2:]),
                        device=device), pose)
                tex_img, tex_mask = get_tex_rl(
                    rl, img, (mesh_world, rl.vi), extrin, intrin,
                    face_index, index_image, bary_image)
            mask = tex_mask.cpu().numpy()
            tex_total += tex_img.cpu().numpy()
            tex_cnt += mask.astype(np.float32)
            rendered.append((fid, cid, int(mask.sum())))
            if view_seconds is not None:
                view_seconds.append(time.perf_counter() - t0)

    tex_mean = tex_total / (tex_cnt + 1e-5)
    tex_mean = np.flip(tex_mean[0].transpose(1, 2, 0), 0)
    out_dir = os.path.join(str(config.data.get("root_path", ".")), "uv_image")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "color_mean.png")
    scale = 1.0 if tex_mean.max() > 2.0 else 255.0
    _save_png(out_path, np.clip(tex_mean * scale, 0, 255).astype(np.uint8))
    logger.info(f"wrote {out_path} from {len(rendered)} views "
                f"({len(skipped)} skipped)")
    return {"path": out_path, "rendered": rendered, "skipped": skipped,
            "covered": float((tex_cnt[0, 0] > 0).mean())}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(load_config(sys.argv[1], overrides=sys.argv[2:]))
