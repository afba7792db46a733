"""Parity of one mesh_vae training step of the port with the JAX package on
the CPU, at the sizes of tests/test_mesh_vae.py (48x48 images, uv 64, tex
128, the 8x12 sphere) with PoseToShadow and the loss set of its
``test_mesh_vae_train_step``: every loss term and every parameter gradient,
through the rasterizer's edge-gradient backward and the recomputed decoder
trunk. Also the training draws, ``MeshVAESummary`` with the color and
normal helpers it calls, and ``run_train.main`` on configs/mesh_vae.yml.

Both sides take the jittered template of tests/test_torch_mesh_vae.py
(the reason is given there), so the JAX step runs under ``jax.jit``. Both
take the port's initialization (seed 0), put into the JAX model's
parameter tree by name (the inverse of ``params_from_jax``, held by a round
trip): ``init`` of the JAX model runs its whole forward and takes ~95 s on
one core, eager or jitted, where ``jax.eval_shape`` of it takes ~3 s. The
two packages cannot draw the same random numbers, so the step is compared
with ``noise_std=0`` in both encoders (the noise is multiplied by 0 on both
sides); the draws are tested on the port alone.

Tolerances: losses rtol 1e-4 (float32 sums in other orders, as the eval
parity test). Parameter gradients rtol 1e-3 plus atol 1e-3 of the
parameter's largest |reference| gradient entry: they sum float32
convolution and scatter gradients over the texture, the render and the
edge pairs in other orders. The summary's images rtol 1e-5 / atol 1e-6
(elementwise float32 formulas).
"""

import json
import os
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import params_from_jax
from goliath_torch.losses import ModularLoss as TModularLoss
from goliath_torch.models.mesh_vae import AutoEncoder as TAutoEncoder
from goliath_torch.models.mesh_vae import MeshVAESummary as TSummary
from goliath_torch.scripts import run_train as t_run_train
from goliath_torch.test import to_device
from goliath_torch.utils import geom as t_geom
from goliath_torch.utils import image as t_image
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.models.mesh_vae import AutoEncoder as JAutoEncoder
from goliath_tpu.models.mesh_vae import MeshVAESummary as JSummary
from goliath_tpu.utils import geom as j_geom
from goliath_tpu.utils import image as j_image

from tests.test_torch_mesh_vae import MODEL_KW, jitter_template

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

CPU = torch.device("cpu")
ITERATION = 100
# the loss set of tests/test_mesh_vae.py::test_mesh_vae_train_step
LOSSES = {
    "rgb_l1": {"src_key": "rgb", "tgt_key": "image",
               "mask_key": "image_mask", "weight": 1.0},
    "geom_l2": {"weight": 0.1, "src_key": "geom",
                "tgt_key": "registration_vertices"},
    "geom_lap": {"weight": 0.1, "src_key": "geom",
                 "tgt_key": "registration_vertices"},
    "kl": 0.002,
    "face_kl": 0.002,
    "pose_shadow_l2": 0.1,
    "learn_blur": 0.001,
}
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "mesh_vae.yml")


def _model_kw(ds, noise_std=0.0):
    kw = dict(MODEL_KW, assets=ds.static_assets,
              pose_to_shadow={"n_pose_dims": 12, "uv_size": 128},
              cal={"identity_camera": ds.static_assets.camera_ids[0]},
              learn_blur=True)
    kw["encoder"] = dict(kw["encoder"], noise_std=noise_std)
    kw["encoder_face"] = dict(kw["encoder_face"], noise_std=noise_std)
    return kw


def _dataset():
    return jitter_template(SyntheticDataset(n_cams=2, n_frames=2, img_h=48,
                                            img_w=48, uv_size=64, seed=2))


def _batch(ds):
    batch = next(ds.batches(2, 1))
    return {k: v for k, v in batch.items() if not isinstance(v, list)}


def _jax_params(shapes: Mapping, state: Mapping[str, torch.Tensor]):
    """The flax parameter tree of ``shapes`` (``jax.eval_shape`` of the
    JAX model's init) filled from the port's ``state_dict``, whose keys
    join the tree's path with dots."""
    def fill(node, prefix):
        return {k: fill(v, f"{prefix}{k}.") if isinstance(v, Mapping)
                else jnp.asarray(state[prefix + k].numpy().reshape(v.shape))
                for k, v in node.items()}

    return {"params": fill(shapes["params"], "")}


@pytest.fixture(scope="module")
def jax_step():
    """One train=True forward, the losses and the parameter gradients of
    the JAX package (module scope: compiling the step is the slow part)."""
    ds = _dataset()
    kw = _model_kw(ds)
    batch = _batch(ds)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JAutoEncoder(**kw)
    state = TAutoEncoder(**kw, device="cpu").module.state_dict()
    # a non-zero per-camera pixel bias, as in the eval parity test
    state["pixel_cal.bias"] = torch.from_numpy(np.random.RandomState(3).randn(
        *state["pixel_cal.bias"].shape).astype(np.float32))
    params = _jax_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb),
                         state)
    round_trip = params_from_jax(jax.device_get(params))
    assert set(round_trip) == set(state)
    assert all(torch.equal(round_trip[k], v) for k, v in state.items())
    loss_fn = JModularLoss(LOSSES, assets=ds.static_assets)

    def loss_inner(p):
        preds = jm.apply(p, jb, train=True,
                         rngs={"noise": jax.random.PRNGKey(3)})
        total, ldict = loss_fn(preds, jb, ITERATION)
        return total, (ldict, preds)

    (total, (ldict, preds)), grads = jax.jit(jax.value_and_grad(
        loss_inner, has_aux=True))(params)
    return dict(
        ds=ds, batch=batch, params=jax.device_get(params),
        total=float(total), ldict={k: float(v) for k, v in ldict.items()},
        grads=jax.device_get(grads),
        preds={k: np.asarray(v) for k, v in preds.items()})


def test_train_step_losses_and_gradients_match_jax(jax_step):
    ds = jax_step["ds"]
    tm = TAutoEncoder(**_model_kw(ds), device="cpu")
    tm.module.load_state_dict(params_from_jax(jax_step["params"]),
                              strict=True)
    loss_fn = TModularLoss(LOSSES, assets=ds.static_assets)
    tb = to_device(jax_step["batch"], CPU)
    preds = tm.apply(tb, train=True)
    total, ldict = loss_fn(preds, tb, ITERATION)
    total.backward()

    assert set(preds) == set(jax_step["preds"])
    assert "pose_shadow_map" in preds and "shadow_map" in preds
    assert set(ldict) == set(jax_step["ldict"])
    np.testing.assert_allclose(total.item(), jax_step["total"], rtol=1e-4)
    for k, ref in jax_step["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), ref, rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    assert jax_step["ldict"]["loss_pose_shadow_l2"] > 0

    ref_grads = params_from_jax(jax_step["grads"])
    named = dict(tm.module.named_parameters())
    assert set(named) == set(ref_grads)
    for name, p in named.items():
        r = ref_grads[name].numpy()
        assert p.grad is not None and p.grad.shape == r.shape, name
        assert np.isfinite(r).all(), name
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=name)
    for top in ("decoder", "encoder", "decoder_view", "upscale_net",
                "pose_to_shadow"):
        assert any(float(p.grad.abs().max()) > 0
                   for n, p in named.items() if n.startswith(top + ".")), top
    # the recomputed trunk passes its gradients on
    assert float(named["decoder.conv_block0.conv1.weight_v"].grad.abs()
                 .max()) > 0


def test_training_draws_come_from_the_generator(jax_step):
    """noise_std=1: each encoder's noise has its latent's shape and unit
    scale; the same generator seed gives the same draws, another seed
    others; a given noise is used as it is; eval draws nothing."""
    ds, batch = jax_step["ds"], to_device(jax_step["batch"], CPU)

    def preds(seed, **extra):
        tm = TAutoEncoder(**_model_kw(ds, noise_std=1.0), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return tm, tm.apply({**batch, **extra}, train=True)

    _, p_a = preds(5)
    _, p_b = preds(5)
    tm, p_c = preds(6)
    for prefix, n in (("", 16), ("face_", 8)):
        embs, mu, logvar = (p_a[f"{prefix}embs{s}"]
                            for s in ("", "_mu", "_logvar"))
        assert torch.equal(embs, p_b[f"{prefix}embs"])
        assert not torch.equal(embs, p_c[f"{prefix}embs"])
        noise = (embs - mu) / torch.exp(logvar)
        assert noise.shape == (2, n)
        assert 0.4 < float(noise.std()) < 1.8, prefix
    given = {"noise": torch.full((2, 16), 0.25),
             "face_noise": torch.full((2, 8), -0.5)}
    with torch.no_grad():
        p = tm.apply({**batch, **given}, train=True)
        ev = tm.apply(batch, train=False)
    for prefix, key in (("", "noise"), ("face_", "face_noise")):
        torch.testing.assert_close(
            p[f"{prefix}embs"], p[f"{prefix}embs_mu"]
            + torch.exp(p[f"{prefix}embs_logvar"]) * given[key])
        assert torch.equal(ev[f"{prefix}embs"], ev[f"{prefix}embs_mu"])
    assert "pose_shadow_map" not in ev


def test_summary_and_its_helpers_match_jax(jax_step):
    """MeshVAESummary on the JAX step's render, depth and the batch, and
    the color helpers beside it (linear2display in both modes,
    srgb2linear, linear2color_corr, depth2normals) on the same inputs."""
    batch = jax_step["batch"]
    preds = {k: jax_step["preds"][k] for k in ("rgb", "depth")}
    assert (preds["depth"] > 0).any() and (preds["depth"] == 0).any()
    ref = JSummary()({k: jnp.asarray(v) for k, v in preds.items()},
                     {k: jnp.asarray(v) for k, v in batch.items()})
    got = TSummary()({k: torch.from_numpy(v) for k, v in preds.items()},
                     to_device(batch, CPU))
    assert set(got) == set(ref) == {"render", "gt", "normals"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(np.abs(ref["normals"]).max()) > 0

    x = np.random.RandomState(4).uniform(-10, 300, (2, 3, 8, 8)).astype(
        np.float32)
    cases = [
        (t_image.linear2display, j_image.linear2display, {}),
        (t_image.linear2display, j_image.linear2display, {"mode": "gamma"}),
        (t_image.srgb2linear, j_image.srgb2linear, {}),
        (t_image.linear2color_corr, j_image.linear2color_corr, {"dim": 1}),
    ]
    for t_fn, j_fn, kw in cases:
        inp = x / 255.0 if t_fn is not t_image.linear2display else x
        np.testing.assert_allclose(
            t_fn(torch.from_numpy(inp), **kw).numpy(),
            np.asarray(j_fn(jnp.asarray(inp), **kw)), rtol=1e-5, atol=1e-6,
            err_msg=f"{t_fn.__name__} {kw}")
    args = (preds["depth"], batch["focal"], batch["princpt"])
    np.testing.assert_allclose(
        t_geom.depth2normals(*map(torch.from_numpy, args)).numpy(),
        np.asarray(j_geom.depth2normals(*map(jnp.asarray, args))),
        rtol=1e-5, atol=1e-6)


def _train_overrides(run_dir):
    small = {
        "data": {"synthetic": True, "img_h": 48, "img_w": 48, "uv_size": 64,
                 "n_cams": 2, "n_frames": 2, "seed": 2},
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
        f"train.run_dir={run_dir}", "train.n_max_iters=2",
        "train.resume=false", "train.log_every_n_steps=1",
        "dataloader.batch_size=2", "dataloader.num_workers=0"]


def test_run_train_on_the_mesh_vae_config(tmp_path):
    """run_train.main on configs/mesh_vae.yml at the small sizes on the CPU:
    2 steps with the config's schedules and its losses that synthetic data
    runs (rgb_l1 and mask_l1 on image_mask, geom_l2, geom_lap, learn_blur,
    kl, face_kl), the summary at iteration 0 and a checkpoint."""
    cfg = t_load_config(_CFG, overrides=_train_overrides(tmp_path / "run"))
    losses = {k: cfg.loss.losses[k] for k in (
        "rgb_l1", "mask_l1", "geom_l2", "geom_lap", "learn_blur", "kl",
        "face_kl")}
    losses["rgb_l1"]["mask_key"] = "image_mask"
    losses["mask_l1"]["tgt_key"] = "image_mask"
    cfg.loss.losses = losses
    iteration, last = t_run_train.main(cfg, device="cpu")
    assert iteration == 2
    assert {f"loss_{k}" for k in losses} | {"loss_total"} == set(last)
    assert all(np.isfinite(v) for v in last.values())
    ckpts = tmp_path / "run" / "checkpoints"
    assert (ckpts / "latest").read_text() == "000002.pt"
    state = torch.load(ckpts / "000002.pt", weights_only=True)
    assert state["iteration"] == 2
    assert "decoder.conv_block0.conv1.weight_v" in state["model"]
    with open(tmp_path / "run" / "tb" / "scalars.jsonl") as f:
        steps = {json.loads(line)["step"] for line in f}
    assert steps == {0, 1}
