"""Part of tests/test_torch_losses_train.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch import losses as tl
from goliath_torch.data.synthetic import SyntheticDataset
from goliath_tpu import losses as jl
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset

from tests.test_torch_losses_train import RTOL, _LOSSES, _assets, _dicts

torch.set_num_threads(1)


@pytest.mark.parametrize("name", (sorted(_LOSSES))[16:18])
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
