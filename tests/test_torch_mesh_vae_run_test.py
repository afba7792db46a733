"""The port's run_test.main on configs/mesh_vae.yml against the JAX
package's, on the CPU, at the sizes of tests/test_mesh_vae.py, with the
loss overrides the full-width chip run takes: the config's rgb_l1, geom_l2
and geom_lap with their schedules, and mask_l1 against ``image_mask``
(effnet needs weights that are not in the repo, head_geom_l2 and head_lap a
capture asset, and the synthetic data yields no ``segmentation_fgbg``).

Both datasets get the jittered template of tests/test_torch_mesh_vae.py
(the reason is given there). The JAX run initializes with PRNGKey(0); the
port loads that initialization from a .pt file.

Tolerance: rtol 1e-4 on the loss means (means over the images and meshes
of outputs held in tests/test_torch_mesh_vae.py).
"""

import ast
import json
import os

import jax
import numpy as np
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import params_from_jax
from goliath_torch.scripts import run_test as t_run_test
from goliath_tpu import test as j_test_lib
from goliath_tpu.config import load_config
from goliath_tpu.scripts import run_test as j_run_test

from tests.test_torch_mesh_vae import jitter_template

torch.set_num_threads(1)

RTOL = 1e-4
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "mesh_vae.yml")


def eval_losses(cfg):
    """``cfg`` with loss.losses cut to the eval losses synthetic data runs."""
    losses = {k: cfg.loss.losses[k] for k in ("rgb_l1", "geom_l2",
                                              "geom_lap", "mask_l1")}
    losses["mask_l1"]["tgt_key"] = "image_mask"
    cfg.loss.losses = losses
    return cfg


def _overrides():
    small = {
        "test.data": {"synthetic": True, "img_h": 48, "img_w": 48,
                      "uv_size": 64, "n_cams": 2, "n_frames": 2, "seed": 2},
        "model.encoder": {"n_embs": 16, "enc_size": 64},
        "model.encoder_face": {"n_embs": 8, "enc_size": 32},
        "model.decoder": {"init_uv_size": 16, "n_pose_dims": 6,
                          "n_pose_enc_channels": 8, "n_embs": 16,
                          "n_embs_enc_channels": 8, "n_face_embs": 8,
                          "n_init_channels": 16, "n_min_channels": 4,
                          "uv_size": 64},
        "model.decoder_view": {"net_uv_size": 64, "n_init_ftrs": 4},
        "model.shadow_net": {"uv_size": 128, "shadow_size": 32, "n_dims": 8},
        "model.renderer": {"image_height": 48, "image_width": 48,
                           "max_faces_per_tile": 128, "chunk": 16},
        "model.pixel_cal": {"image_height": 48, "image_width": 48,
                            "ds_rate": 8},
    }
    return [f"{k}={json.dumps(v)}" for k, v in small.items()] + [
        "test.ckpt=null", "test.vis_path=null", "test.n_test_frames=3"]


def test_mesh_vae_run_test_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for mod in (j_run_test, t_run_test):
        build = mod.build_dataset
        monkeypatch.setattr(mod, "build_dataset",
                            lambda cfg, _b=build, **kw: jitter_template(
                                _b(cfg, **kw)))
    seen = {}
    j_test = j_test_lib.test

    def spy(model, loss_fn, data, config, params, **kw):
        seen["params"] = params
        return j_test(model, loss_fn, data, config, params, **kw)

    monkeypatch.setattr(j_test_lib, "test", spy)
    overrides = _overrides()
    j_run_test.main(eval_losses(load_config(_CFG, overrides=overrides)))
    ref = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])

    ckpt = tmp_path / "jax_init.pt"
    torch.save(params_from_jax(jax.device_get(seen["params"])), ckpt)
    frames = []
    got = t_run_test.main(eval_losses(
        t_load_config(_CFG, overrides=overrides[:-3] + [
            f"test.ckpt={{ckpt_path: {ckpt}}}", "test.vis_path=null",
            "test.n_test_frames=3"])), device="cpu", frame_seconds=frames)
    assert len(frames) == 3
    assert set(got) == set(ref) == {
        "loss_rgb_l1", "loss_geom_l2", "loss_geom_lap", "loss_mask_l1",
        "loss_psnr", "loss_total"}
    assert all(np.isfinite(v) for v in got.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
