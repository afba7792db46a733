"""Parity of the losses that training adds to the port's registry (kl,
learn_blur, backlit_reg, the Laplacian and region geometry losses, rgb_l2,
mask_l1, face_kl, list_l1_reg, primvolsum, alphaprior) with the JAX
package's registry on the same dicts of numpy arrays, values and gradients.

Tolerances: rtol 1e-5 on values (float32 means over a few hundred numbers
on both sides), rtol 1e-4 / atol 1e-7 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_tpu import losses as jl
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from goliath_torch import losses as tl
from goliath_torch.data.synthetic import SyntheticDataset

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

RTOL = 1e-5


def _assets(dataset_cls):
    ds = dataset_cls(n_cams=2, n_frames=2, img_h=16, img_w=16, uv_size=16)
    assets = ds.static_assets
    n = np.asarray(assets.topology.v).shape[0]
    rng = np.random.RandomState(11)
    assets["full_head_mask_geom"] = (rng.rand(n) > 0.3).astype(np.float32)
    assets["mouth_eyes_mask_geom"] = (rng.rand(n) > 0.6).astype(np.float32)
    assets["cheek_mask_geom"] = rng.rand(n).astype(np.float32)
    return assets, n


def _dicts(n_verts):
    rng = np.random.RandomState(12)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    B, N = 2, 40
    preds = {
        "geom": arr(B, n_verts, 3),
        "geom_template_posed": arr(B, n_verts, 3),
        "embs_mu": arr(B, 8), "embs_logvar": arr(B, 8, scale=0.3),
        "face_embs_mu": arr(B, 4), "face_embs_logvar": arr(B, 4, scale=0.3),
        "learn_blur_weights": arr(B, 3) + 1.0,
        "color_rand": arr(B, N, 3), "cos_weight": arr(B, N, 1, scale=0.5),
        "rendered_rgb": rng.rand(B, 3, 6, 7).astype(np.float32),
        "rendered_mask": rng.rand(B, 1, 6, 7).astype(np.float32),
        "spec_dnml": arr(B, N, 3),
        "primscale": (rng.rand(B, N, 3) * 5 + 0.5).astype(np.float32),
        "alpha": rng.rand(B, 1, 6, 7).astype(np.float32),
    }
    targets = {
        "registration_vertices": arr(B, n_verts, 3),
        "image": rng.rand(B, 3, 6, 7).astype(np.float32),
        "image_mask": (rng.rand(B, 1, 6, 7) > 0.2).astype(np.float32),
    }
    return preds, targets


# name -> (init kwargs, the preds keys the loss differentiates)
_LOSSES = {
    "kl": ({}, ["embs_mu", "embs_logvar"]),
    "face_kl": ({}, ["face_embs_mu", "face_embs_logvar"]),
    "learn_blur": ({}, ["learn_blur_weights"]),
    "backlit_reg": ({}, ["color_rand", "cos_weight"]),
    "geom_lap": ({}, ["geom"]),
    "geom_lap_penalty": ({}, ["geom"]),
    "geom_lap_template": ({}, ["geom", "geom_template_posed"]),
    "region_geom_l2": ({"region_mask_name": "cheek_mask_geom"}, ["geom"]),
    "region_lap": ({"region_mask_name": "cheek_mask_geom"}, ["geom"]),
    "region_lap_penalty": ({"region_mask_name": "cheek_mask_geom"}, ["geom"]),
    "head_geom_l2": ({}, ["geom"]),
    "head_lap": ({}, ["geom"]),
    "mouth_eyes_lap_penalty": ({}, ["geom"]),
    "rgb_l2": ({}, ["rendered_rgb"]),
    "mask_l1": ({}, ["rendered_mask"]),
    "list_l1_reg": ({}, ["spec_dnml"]),
    "primvolsum": ({}, ["primscale"]),
    "alphaprior": ({}, ["alpha"]),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_training_loss_matches_jax_registry(name):
    kwargs, wrt = _LOSSES[name]
    j_assets, n = _assets(JSyntheticDataset)
    t_assets, _ = _assets(SyntheticDataset)
    preds, targets = _dicts(n)
    if name == "list_l1_reg":   # a list of terms under one key
        preds["spec_dnml"] = np.stack([preds["spec_dnml"],
                                       2.0 * preds["spec_dnml"]])

    j_fn = jl.get_loss(name, j_assets, dict(kwargs))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def j_value(diff):
        return j_fn({**{k: jnp.asarray(v) for k, v in preds.items()}, **diff},
                    jt)

    ref, ref_g = jax.value_and_grad(j_value)(
        {k: jnp.asarray(preds[k]) for k in wrt})

    t_fn = tl.get_loss(name, t_assets, dict(kwargs))
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    for k in wrt:
        tp[k].requires_grad_(True)
    got = t_fn(tp, {k: torch.from_numpy(v) for k, v in targets.items()})
    got.backward()
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    assert np.isfinite(float(ref)) and float(ref) != 0.0
    for k in wrt:
        r = np.asarray(ref_g[k])
        g = tp[k].grad
        if name == "geom_lap_template" and k == "geom_template_posed":
            # stop_gradient on the JAX side, detach() here
            assert not r.any() and g is None
            continue
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-7,
                                   err_msg=f"{name} d{k}")


def test_training_config_builds_the_same_modular_loss():
    """The loss section of configs/rgca.yml (schedules included) gives the
    same total and terms in both packages at several iterations."""
    import os

    from goliath_tpu.config import load_config as j_load_config
    from goliath_torch.config import load_config as t_load_config

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "configs", "rgca.yml")
    j_assets, n = _assets(JSyntheticDataset)
    t_assets, _ = _assets(SyntheticDataset)
    preds, targets = _dicts(n)
    preds["rgb"] = np.random.RandomState(13).rand(2, 3, 16, 16).astype(
        np.float32)
    targets["image"] = np.random.RandomState(14).rand(2, 3, 16, 16).astype(
        np.float32)
    targets["image_weight"] = np.ones((2, 1, 16, 16), np.float32)
    preds["primscale_preclip"] = preds["primscale"]
    preds["diff_color"] = preds["color_rand"]
    j_loss = jl.ModularLoss(dict(j_load_config(path).loss.losses), j_assets)
    t_loss = tl.ModularLoss(dict(t_load_config(path).loss.losses), t_assets)
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    # l2_reg decays to 0 at 10000; backlit_reg is on in [500000, 600000]
    for iteration in (0, 5000, 20000, 550000):
        ref_total, ref = j_loss(jp, jt, iteration)
        got_total, got = t_loss(tp, tt, iteration)
        assert set(got) == set(ref)
        assert {"loss_kl", "loss_learn_blur", "loss_backlit_reg"} <= set(got)
        np.testing.assert_allclose(got_total.item(), float(ref_total),
                                   rtol=1e-4, err_msg=str(iteration))
        for k in ref:
            np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-4,
                                       err_msg=f"{k} at {iteration}")
