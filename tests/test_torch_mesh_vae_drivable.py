"""Parity of the port's drivable mesh-VAE eval forward
(models/mesh_vae_drivable.py, train=False) with the JAX package on the CPU,
at the sizes of tests/test_mesh_vae_drivable.py (32x32 images, uv 64, tex
128, the face decoder at 32^2) with PoseToShadow, on the jittered template
of tests/test_torch_mesh_vae.py (so the JAX forward runs under
``jax.jit``; the reason is given there), and the weights carried across:
the JAX parameter tree, the port's names and its ``.pt`` checkpoint.

The JAX model takes the port's initialization through its parameter tree
(``jax.eval_shape`` of its init, filled by name), with a non-zero
per-camera pixel bias and face decoder bias. Both packages take the same
batch: the fixture's keys with the drivable ones beside them
(tests/drivable_fixture.py).

Tolerances (those of tests/test_torch_mesh_vae.py): face index images equal
on >= 99.9% of covered pixels and coverage equal; alpha at atol/rtol 1e-4
and depth at rtol 5e-4 where the face agrees; rgb at rtol 1e-4 + 1e-3 of
the image's largest |value| where the face agrees; every other output,
``face_dec_preds``' three included, at rtol 1e-4 + 1e-4 of its largest
|value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch import train as t_train
from goliath_torch.config import load_class
from goliath_torch.convert import load_checkpoint, load_params, params_from_jax
from goliath_torch.models import mesh_vae_drivable as tmd
from goliath_torch.ops import rasterizer as tr
from goliath_torch.optim import build_optimizer
from goliath_torch.test import to_device
from goliath_tpu.models.mesh_vae_drivable import AutoEncoder as JAutoEncoder
from goliath_tpu.ops import rasterizer as jr
from tests.drivable_fixture import (
    IMG,
    dataset,
    drivable_batch,
    jax_params,
    model_kw,
)
from tests.test_torch_mesh_vae import close_to_scale

torch.set_num_threads(1)

RTOL = 1e-4


@pytest.fixture(scope="module")
def both():
    ds = dataset()
    kw = model_kw(ds)
    batch = drivable_batch(ds)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tm = tmd.AutoEncoder(**kw, device="cpu")
    state = tm.module.state_dict()
    rng = np.random.RandomState(3)
    for k in ("pixel_cal.bias", "decoder_face.bias"):
        state[k] = torch.from_numpy(
            rng.randn(*state[k].shape).astype(np.float32) * 0.5)
    tm.module.load_state_dict(state, strict=True)
    jm = JAutoEncoder(**kw)
    params = jax_params(jm, jb, state)
    ref = jax.jit(lambda p: jm.apply(p, jb, train=False))(params)
    with torch.no_grad():
        got = tm.apply(to_device(batch, torch.device("cpu")))
    return ds, batch, jm, tm, params, ref, got


def _index_images(jm, tm, batch, ref, got):
    K, Rt = batch["K"], batch["Rt"]
    j_vp = np.asarray(jr.transform(ref["geom"], jnp.asarray(K),
                                   jnp.asarray(Rt)))
    t_vp = tr.transform(got["geom"], torch.from_numpy(K), torch.from_numpy(Rt))
    kw = dict(max_faces_per_tile=128, chunk=16)
    j_idx = np.stack([np.asarray(jax.jit(lambda x: jr.rasterize(
        x, jnp.asarray(jm.geo_fn.vi), IMG, IMG, **kw))(jnp.asarray(v)))
        for v in j_vp])
    t_idx = np.stack([tr.rasterize(v, tm.geo_fn.vi, IMG, IMG, **kw).numpy()
                      for v in t_vp])
    return j_idx, t_idx


def test_drivable_forward_matches_jax(both):
    _ds, batch, jm, tm, _params, ref, got = both
    assert set(got) == set(ref)
    assert set(got["face_dec_preds"]) == set(ref["face_dec_preds"]) == {
        "face_geom", "face_tex_raw", "face_tex"}
    j_idx, t_idx = _index_images(jm, tm, batch, ref, got)
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
    rest = sorted(set(ref) - {"alpha", "depth", "rgb", "depth_disc_mask",
                              "face_dec_preds"})
    outputs = [(k, got[k], ref[k]) for k in rest] + [
        (f"face_dec_preds.{k}", got["face_dec_preds"][k], v)
        for k, v in ref["face_dec_preds"].items()]
    for k, g, r in outputs:
        assert tuple(g.shape) == r.shape, k
        close_to_scale(g.numpy(), r, err_msg=k)
    # eval takes the distilled shadow map and no noise
    assert "pose_shadow_map" not in got
    assert torch.equal(got["embs"], got["embs_mu"])
    assert torch.equal(got["face_embs"], got["face_embs_mu"])


def test_the_flax_tree_and_the_port_checkpoint_load(both, tmp_path):
    """The JAX model's parameter tree loads into the port with no unknown
    and no missing key (the mesh_vae base's placeholder encoders leave
    nothing behind), the submodules carry the flax names, and the port's
    ``.pt`` train state of this model reads back through
    ``load_checkpoint`` and ``load_params``."""
    ds, _batch, _jm, tm, params, _ref, _got = both
    flat = params_from_jax(jax.device_get(params))
    state = tm.module.state_dict()
    assert set(flat) == set(state)
    fresh = tmd.AutoEncoder(**model_kw(ds), device="cpu")
    fresh.module.load_state_dict(flat, strict=True)
    assert all(torch.equal(fresh.module.state_dict()[k], v)
               for k, v in state.items())
    assert {k.split(".")[0] for k in state} == {
        "encoder", "encoder_face", "decoder_face", "decoder", "decoder_view",
        "shadow_net", "pose_to_shadow", "upscale_net", "cal", "learn_blur",
        "pixel_cal"}
    for name in ("encoder.verts_conv.conv1.weight_v",
                 "encoder.joint0.conv1.weight_v", "encoder.mu.weight_v",
                 "encoder.logvar.weight_v",
                 "encoder_face.conv0.conv1.weight_v",
                 "encoder_face.geommod.weight_v",
                 "encoder_face.jointmod.weight_v",
                 "encoder_face.mu.weight_v", "encoder_face.logvar.weight_v",
                 "decoder_face.encmod.weight_v",
                 "decoder_face.geommod.weight_v",
                 "decoder_face.viewmod.weight_v",
                 "decoder_face.texfc.weight_v",
                 "decoder_face.texmod_up0.weight_v",
                 "decoder_face.texmod_up1.weight_v",
                 "decoder_face.texmod_out.weight_v", "decoder_face.bias"):
        assert name in state, name
    assert load_class("goliath_tpu.models.mesh_vae_drivable.AutoEncoder") \
        is tmd.AutoEncoder
    assert tmd.MeshVAESummary is load_class(
        "goliath_tpu.models.mesh_vae.MeshVAESummary")

    ckpt_dir = tmp_path / "checkpoints"
    optimizer = build_optimizer({"lr": 1e-3}, tm.module)
    t_train.save_checkpoint(str(ckpt_dir), t_train._train_state(
        tm, optimizer), iteration=3)
    restored = load_checkpoint(str(ckpt_dir))
    assert restored["iteration"] == 3
    assert set(restored["model"]) == set(state)
    load_params(fresh.module, str(ckpt_dir))
    assert all(torch.equal(fresh.module.state_dict()[k], v)
               for k, v in state.items())
