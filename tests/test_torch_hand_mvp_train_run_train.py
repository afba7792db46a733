"""Part of tests/test_torch_hand_mvp_train.py's tests, in a file of their own:
a port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.models import hand_mvp as th
from goliath_torch.scripts import run_train as t_run_train

from tests.test_torch_hand_mvp_train import (
    CONFIG_LOSSES,
    IMG,
    _CFG,
    _dataset,
    _model_kw,
    train_overrides,
)

torch.set_num_threads(1)


def test_primalpha_ties_take_half_the_gradient():
    """``primalpha`` is jnp.maximum(alpha, 0): where the alpha decoder's
    output is exactly 0 the gradient is halved, as jax.grad gives it."""
    ds = _dataset()
    net = th.AutoEncoder(**_model_kw(ds), device="cpu").module
    rng = np.random.RandomState(3)
    x = rng.randn(1, 4, 64, 64).astype(np.float32)
    x[0, :, ::3] = 0.0                          # exactly on the bound
    up = rng.randn(1, 4, 1, 64, 64).astype(np.float32)
    leaf = torch.from_numpy(x).requires_grad_()
    net.geomdecoder.alphadecoder.forward = lambda joint: leaf
    pose = torch.from_numpy(ds.get(0, 0)["pose"][None])
    out = net.geomdecoder(pose, net.poseencoder(pose))
    (out["primalpha"] * torch.from_numpy(up)).sum().backward()
    ref = jax.grad(lambda a: jnp.sum(
        jnp.maximum(a.reshape(up.shape), 0.0) * up))(jnp.asarray(x))
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(ref))
    assert (leaf.grad.numpy()[0, :, ::3] == 0.5 * up[0, :, 0, ::3]).all()


def test_run_train_on_the_hand_mvp_config(tmp_path, monkeypatch):
    """run_train.main on configs/hand_mvp.yml at the small sizes on the CPU,
    at its batch 4 with its six losses (vgg on random features, asked for in
    the loss config): 2 steps, the summary at iteration 0, a checkpoint
    with all five parameter groups, and the logged scalars."""
    monkeypatch.delenv("GOLIATH_TORCH_VGG19_NPZ", raising=False)
    summaries = []
    call = th.HandMVPSummary.__call__
    monkeypatch.setattr(th.HandMVPSummary, "__call__", lambda self, p, b: (
        summaries.append(call(self, p, b)) or summaries[-1]))
    cfg = t_load_config(_CFG, overrides=train_overrides(
        tmp_path / "run", extra=[
            "model.uv_size=64",
            "loss.losses.rgb_l2.mask_key=image_mask",
            "loss.losses.vgg.mask_key=image_mask",
            "loss.losses.vgg.allow_random_features=true",
            "loss.losses.mask_l1.tgt_key=image_mask"]))
    iteration, last = t_run_train.main(cfg, device="cpu")
    assert iteration == 2
    assert {f"loss_{k}" for k in CONFIG_LOSSES} | {"loss_total"} == set(last)
    assert all(np.isfinite(v) for v in last.values())
    assert len(summaries) == 1 and set(summaries[0]) == {"render", "alpha",
                                                         "gt"}
    assert all(v.shape == (4, 3, IMG, IMG) and np.isfinite(v).all()
               for v in summaries[0].values())
    ckpts = tmp_path / "run" / "checkpoints"
    assert (ckpts / "latest").read_text() == "000002.pt"
    state = torch.load(ckpts / "000002.pt", weights_only=True)
    assert state["iteration"] == 2
    assert [g["lr"] for g in state["optimizer"]["param_groups"]] == [
        5e-4, 5e-4, 5e-4, 5e-4, 1e-3]
    with open(tmp_path / "run" / "tb" / "scalars.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert {r["step"] for r in logged} == {0, 1}
    assert {r["tag"] for r in logged if r["step"] == 1} >= {
        f"Losses/loss_{k}" for k in CONFIG_LOSSES}
