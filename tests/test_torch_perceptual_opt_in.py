"""Part of tests/test_torch_perceptual.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import os

import numpy as np
import pytest
import torch

from goliath_torch.losses import ModularLoss as TModularLoss, perceptual as tp

from tests.test_torch_perceptual import clean_env, npz

torch.set_num_threads(1)


def test_refuses_without_weights_and_reads_no_jax_variable(npz, clean_env):
    """No weights and no opt-in: every perceptual loss refuses to be built,
    even with the JAX package's opt-in and weight variables set. A named
    file that does not exist is an error, not a fall-back."""
    for k, v in (("GOLIATH_TPU_ALLOW_RANDOM_FEATURES", "1"),
                 ("GOLIATH_TPU_VGG19_NPZ", npz["vgg"]),
                 ("GOLIATH_TPU_EFFNET_NPZ", npz["effnet"])):
        clean_env.setenv(k, v)
    for name in ("vgg", "effnet", "effnet_phys"):
        with pytest.raises(RuntimeError, match="allow_random_features"):
            TModularLoss({name: 1.0})
        with pytest.raises(FileNotFoundError):
            TModularLoss({name: {"weight": 1.0,
                                 "weights_npz": npz["vgg"] + ".missing"}})
    clean_env.setenv(tp.EFFNET_ENV, npz["effnet"])
    loss = TModularLoss({"effnet": 1.0}).fns["effnet"]
    assert loss.weights_path == npz["effnet"]
    with pytest.raises(RuntimeError):
        TModularLoss({"vgg": 1.0})


def test_random_features_opt_in(npz, clean_env):
    """The opt-in is per loss object (the environment is left as it was);
    the features come from the JAX package's seeds, the same on every
    draw, at the JAX package's shapes and He scales; the environment
    variable opts every loss in."""
    cfg = {"effnet": {"weight": 1.0, "allow_random_features": True},
           "vgg": {"weight": 1.0, "allow_random_features": True}}
    a = TModularLoss(cfg)
    assert tp.ALLOW_RANDOM_ENV not in os.environ
    with pytest.raises(RuntimeError):
        TModularLoss({"effnet_phys": 1.0})
    b = TModularLoss(cfg)
    for name, seed in (("effnet", tp.EFFNET_SEED), ("vgg", tp.VGG19_SEED)):
        wa, wb = a.fns[name].net._host, b.fns[name].net._host
        assert a.fns[name].weights_path is None
        assert set(wa) == set(wb)
        assert all(torch.equal(wa[k], wb[k]) for k in wa)
        torch.manual_seed(seed + 1)   # the global generator plays no part
        draw = (tp.effnet_weights if name == "effnet" else tp.vgg19_weights)()
        assert all(torch.equal(wa[k], draw[k]) for k in wa)
        for k, w in wa.items():
            if k.endswith("_b"):
                assert float(w.abs().max()) == 0, k
            else:
                fan_in = w[0].numel()
                assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.35, k
    jshapes = {k: v.shape for k, v in {**npz["effnet_w"],
                                       **npz["vgg_w"]}.items()}
    ours = {**a.fns["effnet"].net._host, **a.fns["vgg"].net._host}
    assert {k: tuple(v.shape) for k, v in ours.items()} == jshapes
    clean_env.setenv(tp.ALLOW_RANDOM_ENV, "1")
    assert TModularLoss({"effnet_phys": 1.0}).fns[
        "effnet_phys"].weights_path is None
