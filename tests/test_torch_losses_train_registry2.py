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


@pytest.mark.parametrize("name", (sorted(_LOSSES))[8:12])
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
