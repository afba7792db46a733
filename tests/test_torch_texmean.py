"""``run_gen_texmean`` of the port against the JAX package's on the CPU, on
a small fake Hands capture (``tests/goliath_capture.py``: 48x48 images, uv
64, 2 cameras, frames 0 and 2 fully lit and frame 1 an OLAT frame, which
both scripts skip), on ``configs/urhand.yml`` with its global scaling of 10
and the cameras placed so that the scaled sphere is in view. The JAX side
runs eagerly, as its script does.

- ``compute_view_texture`` and ``compute_uv_visibility_face`` on the same
  inputs: visibility equal; the texture equal except at texels whose
  projection lies within ``EDGE`` pixels of a pixel edge (the two packages'
  float32 projections round differently there, and the nearest pixel
  flips; 22 of the 4,096 texels here).
- The whole script: the same ``color_mean.png``, byte for byte once
  decoded (no tolerance: both take the same pixel for every texel here).
  The JAX script runs with ``data.partially_lit_only=false``: on the
  config as it stands it renders no view and writes a black mean, which
  the port's script does not (it clears the flag; ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from goliath_capture import CaptureSpec, write_capture, write_shared_assets
from goliath_torch.config import load_config as t_load_config
from goliath_torch.data.synthetic import (
    SyntheticDataset,
    make_camera_ring,
    make_synthetic_lbs,
)
from goliath_torch.ops.rasterizer import rasterize, transform
from goliath_torch.scripts import run_gen_texmean as t_texmean
from goliath_torch.utils import geom as t_geom
from goliath_tpu.config import load_config as j_load_config
from goliath_tpu.scripts import run_gen_texmean as j_texmean
from goliath_tpu.utils import geom as j_geom

torch.set_num_threads(1)

CFG = "configs/urhand.yml"
NAME = "m--20230306--0839--AXE977--pilot--ProjectGoliath--Hands--left"
H = W = 48
UV = 64
# texels closer than this (pixels) to a pixel edge are not held
EDGE = 1e-3


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    base = tmp_path_factory.mktemp("goliath")
    a = SyntheticDataset(n_cams=1, n_frames=1, img_h=H, img_w=W, uv_size=16,
                         device="cpu").static_assets
    topo = {k: np.asarray(v) for k, v in a["topology"].items()}
    # the sphere's radius of 100 is 1,000 at the config's global scaling
    K, Rt, _ = make_camera_ring(2, H, W, dist=4000.0)
    root = write_capture(base, NAME, CaptureSpec(
        kind="Hands", cameras=["400870", "401645"], K=K, Rt=Rt,
        frames=[0, 1, 2], template=topo["v"], faces=topo["vi"],
        image_hw=(H, W), uv_size=UV, pattern_of_frame={0: 0, 1: 1, 2: 0}))
    lbs_json, lbs_cfg = make_synthetic_lbs(topo["v"], topo["vi"], topo["vt"],
                                           topo["vti"])
    write_shared_assets(base / "shared" / "static_assets_hand_left.pt", {
        "topology": topo, "lbs_model_json": lbs_json,
        "lbs_config_dict": lbs_cfg})
    overrides = [f"capture_root={base}", f"model.renderer.image_height={H}",
                 f"model.renderer.image_width={W}", f"texmean_uv_size={UV}"]
    return root, overrides


def _read_mean(root):
    path = root / "uv_image" / "color_mean.png"
    out = np.asarray(Image.open(path))
    path.unlink()
    return out


def test_view_texture_matches_jax(capture):
    rng = np.random.RandomState(0)
    a = SyntheticDataset(n_cams=1, n_frames=1, img_h=H, img_w=W,
                         uv_size=16, device="cpu").static_assets
    vi, vt, vti = (np.asarray(a["topology"][k]) for k in ("vi", "vt", "vti"))
    v = 10.0 * np.asarray(a["topology"]["v"])
    verts = (v + rng.randn(*v.shape))[None].astype(np.float32)
    K, Rt, _ = make_camera_ring(3, H, W, dist=4000.0)
    K, Rt = K[1:2], Rt[1:2]
    image = (255 * rng.rand(1, 3, H, W)).astype(np.float32)
    index_uv = t_geom.make_uv_vert_index(vt, vi, vti, uv_size=UV,
                                         flip_uv=True)
    face_uv, bary_uv = t_geom.make_uv_barys(vt, vti, uv_size=UV,
                                            flip_uv=True)
    index_uv, bary_uv = t_geom.index_image_impaint(index_uv, bary_uv)
    face_uv = t_geom.index_image_impaint(face_uv)
    tv = torch.from_numpy(verts)
    v_pix = transform(tv, torch.from_numpy(K), torch.from_numpy(Rt))
    index_img = rasterize(v_pix[0], torch.from_numpy(vi), H, W)[None]
    assert 0.05 < float((index_img >= 0).float().mean()) < 0.9

    args = (verts, vi, image, index_img.numpy(), None, K, Rt, index_uv,
            bary_uv, face_uv)
    tex, vis = t_geom.compute_view_texture(
        *[torch.from_numpy(np.asarray(x)) if x is not None else None
          for x in args])
    jtex, jvis = j_geom.compute_view_texture(
        *[jnp.asarray(x) if x is not None else None for x in args])
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(
        t_geom.compute_uv_visibility_face(
            index_img, len(vi), torch.from_numpy(face_uv)).numpy(),
        np.asarray(j_geom.compute_uv_visibility_face(
            jnp.asarray(index_img.numpy()), len(vi), jnp.asarray(face_uv))))
    assert 0.05 < float(vis.float().mean()) < 0.95

    # the texels' projections, and their distance to a pixel edge
    idx = np.clip(index_uv, 0, verts.shape[1] - 1)
    xyz = (verts[0][idx] * bary_uv[..., None]).sum(-2).reshape(1, -1, 3)
    pix, _ = t_geom.project_points(torch.from_numpy(xyz.astype(np.float32)),
                                   torch.from_numpy(Rt), torch.from_numpy(K))
    edge = (pix - pix.round()).abs().amin(-1).reshape(UV, UV).numpy()
    held = edge >= EDGE
    assert held.mean() > 0.99   # 4,074 of 4,096 texels here
    np.testing.assert_array_equal(tex.numpy()[..., held],
                                  np.asarray(jtex)[..., held])
    assert float(tex.abs().max()) > 0


def test_run_gen_texmean_matches_jax(capture):
    root, overrides = capture
    # the JAX script on the config as it stands: every view dropped
    j_texmean.main(j_load_config(CFG, overrides=overrides))
    assert not _read_mean(root).any()

    j_texmean.main(j_load_config(
        CFG, overrides=overrides + ["data.partially_lit_only=false"]))
    ref = _read_mean(root)
    seconds = []
    out = t_texmean.main(t_load_config(CFG, overrides=overrides),
                         device="cpu", view_seconds=seconds)
    got = _read_mean(root)
    assert got.shape == ref.shape == (UV, UV, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    # frames 0 and 2 from both cameras; frame 1 (OLAT) has no fully-lit
    # assets and is skipped, as in the JAX script
    assert [v[:2] for v in out["rendered"]] == [
        (0, "400870"), (0, "401645"), (2, "400870"), (2, "401645")]
    assert out["skipped"] == [(1, "400870"), (1, "401645")]
    assert all(v[2] > 0 for v in out["rendered"]) and len(seconds) == 4
    assert 0.1 < out["covered"] < 1.0
    assert 0.1 < (got.max(-1) > 0).mean() <= out["covered"]
