"""Parity of the port's mesh_vae eval forward (models/mesh_vae.py,
train=False) with the JAX package on the CPU, at the sizes of
tests/test_mesh_vae.py (48x48 images, uv 64, tex 128, the 8x12 sphere),
with the JAX initialization carried across by params_from_jax.

The sphere fixture's template has two pole fans of 13 coincident vertices.
Their faces' normals are 0/0 up to rounding, and XLA on the CPU contracts
products into fused multiply-adds under ``jax.jit``, which turns them (and
so the view cosines of the pole vertices, the view-conditioned texture and
the render) into other numbers than any separately rounded evaluation
gives. The template is therefore moved by N(0, 0.5) per vertex on both
sides (``jitter_template``): every face then has a well-defined normal.

On the CPU the JAX model takes the XLA scan z-buffer and the port K5's
plain version; they differ only in tiles over ``max_faces_per_tile``, and
this scene has none.

Tolerances: face index images equal on >= 99.9% of covered pixels and
coverage equal; alpha at atol/rtol 1e-4 and depth at rtol 5e-4 (1/z
interpolated with barycentrics that divide by face areas of down to ~0.2
px^2) where the face agrees; rgb at rtol 1e-4 + 1e-3 of the image's largest
|value| where the face agrees, because it samples a texture whose
neighbouring texels differ by up to ~3e2 (random view-decoder weights times
tex_std 4096), so a texture coordinate rounded 1e-6 apart moves a sample by
up to ~0.3; the other outputs at rtol 1e-4 + 1e-4 of the output's largest
|value| (float32 convolutions summed in other orders, amplified by tex_std
in tex_rec).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.models.mesh_vae import AutoEncoder as TAutoEncoder
from goliath_torch.ops import rasterizer as tr
from goliath_torch.test import to_device
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.models.mesh_vae import AutoEncoder as JAutoEncoder
from goliath_tpu.ops import rasterizer as jr

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

RTOL = 1e-4
MODEL_KW = dict(
    encoder={"n_embs": 16, "enc_size": 64},
    encoder_face={"n_embs": 8, "enc_size": 32},
    decoder={"init_uv_size": 16, "n_pose_dims": 6, "n_pose_enc_channels": 8,
             "n_embs": 16, "n_embs_enc_channels": 8, "n_face_embs": 8,
             "n_init_channels": 16, "n_min_channels": 4},
    decoder_view={"net_uv_size": 64, "n_init_ftrs": 4},
    shadow_net={"uv_size": 128, "shadow_size": 32, "n_dims": 8},
    upscale_net={"n_ftrs": 4},
    renderer={"image_height": 48, "image_width": 48,
              "max_faces_per_tile": 128, "chunk": 16},
    pixel_cal={"image_height": 48, "image_width": 48, "ds_rate": 8},
    uv_size=64, tex_size=128)


def jitter_template(ds):
    v = ds.static_assets["template_mesh_unscaled"]
    ds.static_assets["template_mesh_unscaled"] = (
        v + np.random.RandomState(7).randn(*v.shape) * 0.5).astype(np.float32)
    return ds


def close_to_scale(got, ref, rtol=RTOL, of_scale=RTOL, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=of_scale * float(np.abs(ref).max()),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def both():
    ds = jitter_template(SyntheticDataset(n_cams=2, n_frames=2, img_h=48,
                                          img_w=48, uv_size=64, seed=2))
    kw = dict(MODEL_KW, assets=ds.static_assets,
              pose_to_shadow={"n_pose_dims": 12, "uv_size": 128},
              cal={"identity_camera": ds.static_assets.camera_ids[0]},
              learn_blur=True)
    batch = next(ds.batches(2, 1))
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JAutoEncoder(**kw)
    params = jm.init(jax.random.PRNGKey(0), jb)
    # a non-zero per-camera pixel bias, so that its upsampling shows
    bias = params["params"]["pixel_cal"]["bias"]
    params["params"]["pixel_cal"]["bias"] = jnp.asarray(
        np.random.RandomState(3).randn(*bias.shape).astype(np.float32))
    ref = jax.jit(lambda p: jm.apply(p, jb, train=False))(params)
    tm = TAutoEncoder(**kw, device="cpu")
    tm.module.load_state_dict(params_from_jax(jax.device_get(params)),
                              strict=True)
    with torch.no_grad():
        got = tm.apply(to_device(batch, torch.device("cpu")))
    return ds, batch, jm, tm, ref, got


def _index_images(both):
    _ds, batch, jm, tm, ref, got = both
    K, Rt = batch["K"], batch["Rt"]
    j_vp = np.asarray(jr.transform(ref["geom"], jnp.asarray(K),
                                   jnp.asarray(Rt)))
    t_vp = tr.transform(got["geom"], torch.from_numpy(K), torch.from_numpy(Rt))
    kw = dict(max_faces_per_tile=128, chunk=16)
    j_idx = np.stack([np.asarray(jax.jit(lambda x: jr.rasterize(
        x, jnp.asarray(jm.geo_fn.vi), 48, 48, **kw))(jnp.asarray(v)))
        for v in j_vp])
    t_idx = np.stack([tr.rasterize(v, tm.geo_fn.vi, 48, 48, **kw).numpy()
                      for v in t_vp])
    return j_idx, t_idx


def test_mesh_vae_forward_matches_jax(both):
    _ds, _batch, _jm, _tm, ref, got = both
    assert set(got) == set(ref)
    j_idx, t_idx = _index_images(both)
    np.testing.assert_array_equal(t_idx == -1, j_idx == -1)
    covered = t_idx != -1
    assert covered.mean() > 0.2
    assert (t_idx == j_idx)[covered].mean() >= 0.999
    agree = (t_idx == j_idx)[:, None]
    for k in ("alpha", "depth", "rgb"):
        assert tuple(got[k].shape) == ref[k].shape, k
        g, r = got[k].numpy() * agree, np.asarray(ref[k]) * agree
        if k == "alpha":
            np.testing.assert_allclose(g, r, atol=RTOL, rtol=RTOL)
        elif k == "depth":
            np.testing.assert_allclose(g, r, rtol=5e-4)
        else:
            close_to_scale(g, r, of_scale=1e-3, err_msg=k)
    np.testing.assert_array_equal(
        got["depth_disc_mask"].numpy() * agree,
        np.asarray(ref["depth_disc_mask"]) * agree)
    for k in sorted(set(ref) - {"alpha", "depth", "rgb", "depth_disc_mask"}):
        assert tuple(got[k].shape) == ref[k].shape, k
        close_to_scale(got[k].numpy(), ref[k], err_msg=k)
    assert float(np.abs(np.asarray(ref["learn_blur_weights"])).max()) > 0


def test_mesh_vae_trains_and_keeps_flax_names(both):
    """train=True runs (the step's parity with JAX is
    tests/test_torch_mesh_vae_train.py); the config's class names, the
    device default and the flax parameter names."""
    from goliath_torch.config import load_class
    from goliath_torch.models.mesh_vae import MeshVAESummary

    ds, batch, jm, tm, _ref, got = both
    # configs/mesh_vae.yml names the JAX classes; they load the port's
    assert load_class("goliath_tpu.models.mesh_vae.AutoEncoder") \
        is TAutoEncoder
    assert load_class("goliath_tpu.models.mesh_vae.MeshVAESummary") \
        is MeshVAESummary
    with torch.no_grad():
        train = tm.apply(to_device(batch, torch.device("cpu")), train=True)
    assert set(train) == set(got) | {"pose_shadow_map"}
    assert torch.isfinite(train["rgb"]).all()
    # noise_std 1: the training latent is drawn around the eval one
    assert not torch.equal(train["embs"], got["embs"])
    torch.testing.assert_close(train["embs_mu"], got["embs_mu"])
    if not torch.cuda.is_available():  # the card is the default device
        topo = ds.static_assets.topology
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tr.RenderLayer(48, 48, topo.vi, topo.vt, topo.vti)
    names = set(tm.module.state_dict())
    assert {"decoder.conv_block0.conv1.weight_v",
            "encoder_face.encoder.joint0.conv_resize.bias",
            "shadow_net.shadow_pred.bias", "pixel_cal.bias",
            "pose_to_shadow.out.weight_g"} <= names
