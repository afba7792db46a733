"""The port's run_test.main on configs/urhand.yml against the JAX package's
evaluation of the same model on the same frames, on the CPU, at the sizes
of tests/test_urhand.py (48x48 images, uv 32, 32x32 shadow maps, 2
lights), with the cuts the full-width chip run takes: global_scaling 1 (the
default 10 puts the synthetic sphere's radius of 1,000 around cameras at
distance 400), pose_enc_dims 12 (the synthetic skeleton's 4 joint
triplets), and the config's losses without effnet and effnet_phys (they
need EfficientNet weights that are not in the repo).

The JAX package's own ``scripts/run_test.main`` cannot evaluate URHand: it
passes ``learn_blur=False`` to every model, and the JAX URHand AutoEncoder
takes no such argument (TypeError). The reference here is therefore that
function's body without the argument: the same dataset, frames, losses
(with the injected psnr) and ``test.test`` (the jitted ``model.apply`` and
``ModularLoss``). Its parameters are the port's initialization (seed 0) put
into the JAX tree by name (``jax.eval_shape`` of ``init``: the JAX init
runs the whole forward, ~35 s on one core), which the port's run reads
back from a .pt file of params_from_jax's output. The port's URHand takes ``learn_blur`` and refuses True.

Both datasets get the jittered template of tests/test_torch_mesh_vae.py
(the reason is given there and in tests/test_torch_urhand.py).

Tolerance: rtol 1e-4 on the loss means (means over the images of outputs
held in tests/test_torch_urhand.py).
"""

import ast
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.config import load_from_config as t_load_from_config
from goliath_torch.convert import params_from_jax
from goliath_torch.scripts import run_test as t_run_test
from goliath_tpu import test as j_test_lib
from goliath_tpu.config import Config, load_config, load_from_config
from goliath_tpu.data.pipeline import DataLoader
from goliath_tpu.losses import ModularLoss
from goliath_tpu.scripts import run_test as j_run_test

from tests.test_torch_mesh_vae import jitter_template
from tests.test_torch_mesh_vae_train import _jax_params

torch.set_num_threads(1)

RTOL = 1e-4
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "urhand.yml")
DROPPED_LOSSES = ("effnet", "effnet_phys")
DATA = {"synthetic": True, "img_h": 48, "img_w": 48, "uv_size": 32,
        "n_cams": 2, "n_frames": 2, "n_lights": 2, "seed": 4}


def eval_losses(cfg):
    """``cfg`` with loss.losses cut to the losses synthetic data runs."""
    cfg.loss.losses = {k: v for k, v in cfg.loss.losses.items()
                       if k not in DROPPED_LOSSES}
    return cfg


def _overrides():
    small = {
        "data": DATA, "test.data": DATA,
        "model.renderer": {"image_height": 48, "image_width": 48,
                           "max_faces_per_tile": 128, "chunk": 16},
    }
    return [f"{k}={json.dumps(v)}" for k, v in small.items()] + [
        "model.relight.uv_size=32", "model.relight.init_uv_size=8",
        "model.relight.pose_enc_dims=12", "model.relight.disp_enc_dims=[8, 8, 8]",
        "model.relight.disp_scale=0.3", "model.relight.init_channels=16",
        "model.global_scaling=1.0", "model.shadow_size=32",
        "test.ckpt=null", "test.vis_path=null", "test.n_test_frames=3"]


def jax_eval(config):
    """The JAX package's scripts/run_test.main without learn_blur: its
    means and its initialization."""
    test_cfg = config.get("test", Config())
    dataset = jitter_template(j_run_test.build_dataset(dict(test_cfg.data)))
    model_cfg = Config.wrap(dict(config.model))
    model_cfg.pop("cal", None)
    model = load_from_config(model_cfg, assets=dataset.static_assets)
    losses_cfg = {k: v for k, v in dict(config.loss.losses).items()
                  if k not in j_run_test.TRAIN_ONLY_LOSSES}
    losses_cfg["psnr"] = {"src_key": "rgb", "tgt_key": "image",
                          "mask_key": "image_weight", "weight": 0.0}
    loss_fn = ModularLoss(losses_cfg, assets=dataset.static_assets)
    random.seed(42)
    idxs = random.sample(range(len(dataset)),
                         min(int(test_cfg.n_test_frames), len(dataset)))

    class Subset:
        def __len__(self):
            return len(idxs)

        def __getitem__(self, i):
            return dataset[idxs[i]]

    loader = DataLoader(Subset(), batch_size=1, shuffle=False, num_workers=0,
                        n_epochs=1)
    batch0 = next(iter(loader))
    jb = {k: jnp.asarray(v) for k, v in batch0.items()
          if not isinstance(v, (list, str))}
    state = t_load_from_config(model_cfg, assets=dataset.static_assets,
                               device="cpu").module.state_dict()
    params = _jax_params(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jb)), state)
    means = j_test_lib.test(model, loss_fn, iter(loader), config, params,
                            batch_filter_fn=dataset.batch_filter)
    return means, params


def test_urhand_run_test_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    build = t_run_test.build_dataset
    monkeypatch.setattr(t_run_test, "build_dataset",
                        lambda cfg, **kw: jitter_template(build(cfg, **kw)))
    overrides = _overrides()
    ref, params = jax_eval(eval_losses(load_config(_CFG,
                                                   overrides=overrides)))

    ckpt = tmp_path / "jax_init.pt"
    torch.save(params_from_jax(jax.device_get(params)), ckpt)
    frames = []
    got = t_run_test.main(eval_losses(
        t_load_config(_CFG, overrides=overrides[:-3] + [
            f"test.ckpt={{ckpt_path: {ckpt}}}", "test.vis_path=null",
            "test.n_test_frames=3"])), device="cpu", frame_seconds=frames)
    assert ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert len(frames) == 3
    assert set(got) == set(ref) == {
        "loss_rgb_l1_focus", "loss_rgb_l1_phys", "loss_list_l1_reg",
        "loss_psnr", "loss_total"}
    assert all(np.isfinite(v) for v in got.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)


def test_urhand_refuses_learn_blur():
    """run_test passes learn_blur=False to every model; URHand takes it and
    refuses True: it has no learned blur."""
    cfg = t_load_config(_CFG, overrides=_overrides())
    dataset = t_run_test.build_dataset(dict(cfg.test.data))
    model_cfg = dict(cfg.model)
    model_cfg.pop("cal")
    with pytest.raises(ValueError, match="learned blur"):
        t_load_from_config({**model_cfg, "learn_blur": True},
                           assets=dataset.static_assets, device="cpu")
    model = t_load_from_config({**model_cfg, "learn_blur": False},
                               assets=dataset.static_assets, device="cpu")
    assert not model.cal_enabled
