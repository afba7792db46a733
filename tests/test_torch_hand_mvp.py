"""Parity of the port's MVP hand (models/hand_mvp.py with the primitive
bases of utils/geom.py and the raymarcher) with the JAX package on the
CPU, at the sizes of tests/test_lbs_and_hand_mvp.py (48x48 images, uv 64,
primsize (8, 8, 4), i.e. 64 prims, n_pose_dims 6 for the synthetic 3-joint
skeleton), and of ``run_test.main`` on configs/hand_mvp.yml at those sizes
against the JAX package's evaluation of the same config and frames.

Both packages take the port's initialization (seed 0), put into the JAX
tree by name with ``jax.eval_shape`` of ``init`` (the JAX init runs the
whole forward) and carried back by params_from_jax (a round trip). The
forward and run_test comparisons move the template by N(0, 0.5) per vertex
(tests/test_torch_mesh_vae.py's ``jitter_template``): the sphere's pole
faces are degenerate, and XLA on the CPU contracts products into fused
multiply-adds under ``jax.jit``, which turns their zero TBN frames (which
fall back to the identity) into rotations. The TBN test takes the sphere
as it is, with the JAX functions run eagerly, and holds the port to JAX
wherever JAX is finite.

The JAX package's ``scripts/run_test.main`` reads weights only from an
orbax checkpoint and runs the JAX init; the reference is its body: the
same dataset, frames, losses (with the injected psnr) and ``test.test``.
The config's losses read ``image_mask`` where they read
``segmentation_fgbg`` (synthetic data has none); vgg takes the JAX
package's random VGG19 features, written to an .npz that both packages
read (no ImageNet weights are in the repo).

Tolerance: rtol 1e-4 plus 1e-4 of the output's largest |value| on the
forward's outputs and images, rtol 1e-4 on the loss means (float32
convolutions and the march's sums taken in other orders).
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.config import load_from_config as t_load_from_config
from goliath_torch.convert import params_from_jax
from goliath_torch.models import hand_mvp as th
from goliath_tpu import test as j_test_lib
from goliath_tpu.config import Config, load_from_config
from goliath_tpu.data.pipeline import DataLoader
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.losses import ModularLoss
from goliath_tpu.models import hand_mvp as jh
from goliath_tpu.scripts import run_test as j_run_test

from tests.test_torch_mesh_vae import close_to_scale, jitter_template
from tests.test_torch_mesh_vae_train import _jax_params

torch.set_num_threads(1)

RTOL = 1e-4
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "hand_mvp.yml")
RAYMARCHER = {"dt": 4.0, "max_steps": 64, "max_prims_per_tile": 32,
              "chunk": 8}


def _model_kw(ds):
    return dict(assets=ds.static_assets, image_height=48, image_width=48,
                cal={"identity_camera": ds.static_assets.camera_ids[0]},
                n_pose_dims=6, n_embs=8, volradius=400.0, primsize=(8, 8, 4),
                uv_size=64, prim_scale=12.0, global_scaling=1.0,
                raymarcher=RAYMARCHER)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def both():
    """The jitted JAX forward (train=False, batch 2) and the port's on the
    same parameters and batch."""
    ds = jitter_template(SyntheticDataset(n_cams=2, n_frames=2, img_h=48,
                                          img_w=48, uv_size=64, seed=1))
    kw = _model_kw(ds)
    batch = next(ds.batches(2, 1))
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jh.AutoEncoder(**kw)
    tm = th.AutoEncoder(**kw, device="cpu")
    state = tm.module.state_dict()
    params = _jax_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jb)), state)
    round_trip = params_from_jax(jax.device_get(params))
    assert set(round_trip) == set(state)
    assert all(torch.equal(round_trip[k], v) for k, v in state.items())
    ref = jax.device_get(jax.jit(lambda p, b: jm.apply(p, b, train=False))(
        params, jb))
    tm.module.load_state_dict(round_trip)
    with torch.no_grad():
        got = tm.apply({k: T(v) for k, v in batch.items()}, train=False)
    return got, ref


@pytest.mark.parametrize("key", ([
    "rgb", "alpha", "primpos", "primrot", "primscale", "primalpha",
    "primrgb", "mvp_window_overflow", "geom_lbs", "learn_blur_weights"])[0:4])
def test_hand_mvp_forward_matches_jax(both, key):
    got, ref = both
    assert set(got) == set(ref)
    g, r = got[key].numpy(), np.asarray(ref[key])
    assert g.shape == r.shape and np.isfinite(g).all()
    close_to_scale(g, r, err_msg=key)
    if key == "alpha":
        assert float(r.max()) > 0.05   # the hand is visible


def _overrides():
    data = {"synthetic": True, "img_h": 48, "img_w": 48, "uv_size": 64,
            "n_cams": 2, "n_frames": 2, "seed": 1}
    return [f"data={json.dumps(data)}", f"test.data={json.dumps(data)}",
            "model.image_height=48", "model.image_width=48",
            "model.uv_size=64", "model.primsize=[8, 8, 4]",
            "model.n_embs=8", "model.n_pose_dims=6", "model.volradius=400.0",
            "model.prim_scale=12.0", "model.global_scaling=1.0",
            *(f"model.raymarcher.{k}={v}" for k, v in RAYMARCHER.items()),
            # the config's losses on synthetic data: masks and mask_l1's
            # target from image_mask, vgg on random features
            "loss.losses.rgb_l2.mask_key=image_mask",
            "loss.losses.vgg.mask_key=image_mask",
            "loss.losses.vgg.allow_random_features=true",
            "loss.losses.mask_l1.tgt_key=image_mask",
            "test.ckpt=null", "test.vis_path=null", "test.n_test_frames=3"]


def jax_eval(config):
    """The JAX package's scripts/run_test.main without its checkpoint
    read: its means and its initialization (the port's)."""
    test_cfg = config.get("test", Config())
    dataset = jitter_template(j_run_test.build_dataset(dict(test_cfg.data)))
    model_cfg = Config.wrap(dict(config.model))
    model_cfg.pop("cal", None)
    model_cfg["learn_blur"] = False
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
    jb = {k: jnp.asarray(v) for k, v in next(iter(loader)).items()
          if not isinstance(v, (list, str))}
    state = t_load_from_config(model_cfg, assets=dataset.static_assets,
                               device="cpu").module.state_dict()
    params = _jax_params(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jb)), state)
    means = j_test_lib.test(model, loss_fn, iter(loader), config, params,
                            batch_filter_fn=dataset.batch_filter)
    return means, params
