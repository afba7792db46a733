"""Part of tests/test_torch_hand_teacher_train.py's tests, in a file of their
own: a port test file that runs long holds at most four tests, so that
pytest-xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.models import hand_teacher_mvp as tt
from goliath_torch.scripts import run_train as t_run_train
from goliath_torch.test import to_device
from goliath_tpu.models import hand_teacher_mvp as jt

from tests.test_torch_hand_mvp_train import train_overrides
from tests.test_torch_hand_teacher_train import (
    CONFIG_LOSSES,
    CPU,
    DATA,
    IMG,
    TRAIN_RAYMARCHER,
    _CFG,
    jax_step,
)

torch.set_num_threads(1)


def test_texolat_ties_take_half_the_gradient(jax_step):
    """``texolat`` enters the relit colour as jnp.maximum(texolat, 0): with
    the UNet's output put where 25 tex + 100 is exactly 0, that entry takes
    half the gradient, as jax.grad of the JAX package's expression gives
    it."""
    batch = jax_step["batch"]
    net = jax_step["model"].module
    dec = net.relightdecoder
    rng = np.random.RandomState(6)
    B, L, pz, S = 1, 2, 4, 32
    tex = rng.randn(B * L, pz * 4, S, S).astype(np.float32)
    tex.reshape(B, L, pz, 4, S, S)[:, :, :, 1:, ::2] = -4.0  # on the bound
    leaf = torch.from_numpy(tex.copy()).requires_grad_()
    orig = dec.unet.forward
    dec.unet.forward = lambda x, jf: leaf
    try:
        pose = torch.from_numpy(batch["pose"])
        geo = net.geomdecoder(pose, net.poseencoder(pose))
        li = torch.from_numpy(batch["light_intensity"])
        out = dec(torch.from_numpy(batch["campos"]), geo["primpos"],
                  geo["primrot"], geo["primscale"], geo["primalpha"],
                  net.valid_prims, net.poseencoder2(pose),
                  torch.from_numpy(batch["light_pos"]), li)
    finally:
        dec.unet.forward = orig
    up = rng.randn(*out["primrgb"].shape).astype(np.float32)
    (out["primrgb"] * torch.from_numpy(up)).sum().backward()

    def jf(t):
        t = t.reshape(B, L, pz, 4, S, S)
        lij = jnp.asarray(batch["light_intensity"])[:, :, None, :, None, None]
        rgb = jnp.sum(jax.nn.sigmoid(t[:, :, :, :1])
                      * jnp.maximum(25.0 * t[:, :, :, 1:] + 100.0, 0.0)
                      * lij, axis=1).reshape(B, pz, 3, S, S)
        return jnp.sum(rgb * up)

    ref = np.asarray(jax.grad(jf)(jnp.asarray(tex)))
    np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=1e-5, atol=1e-7)
    g = leaf.grad.numpy().reshape(B, L, pz, 4, S, S)[:, :, :, 1:, ::2]
    assert np.abs(g).max() > 0                   # half, not none


def test_summary_of_a_training_step_matches_jax(jax_step):
    preds = jax_step["runs"]["live"]["preds"]
    batch = jax_step["batch"]
    ref = jt.HandMVPSummary()({k: preds[k] for k in ("rgb", "alpha")}, batch)
    got = tt.HandMVPSummary()({k: torch.from_numpy(np.asarray(preds[k]))
                               for k in ("rgb", "alpha")},
                              to_device(batch, CPU))
    assert set(got) == set(ref) == {"render", "alpha", "gt"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert float(ref["alpha"].max()) > 0.01


def test_run_train_on_the_teacher_config(tmp_path, monkeypatch):
    """run_train.main on configs/hand_teacher_mvp.yml at the small sizes
    on the CPU, at its batch 1 with its three losses: 2 steps, the summary
    at iteration 0, a checkpoint with the five parameter groups, the
    logged scalars, and the geometry moved by the decay alone."""
    summaries = []
    call = tt.HandMVPSummary.__call__
    monkeypatch.setattr(tt.HandMVPSummary, "__call__", lambda self, p, b: (
        summaries.append(call(self, p, b)) or summaries[-1]))
    cfg = t_load_config(_CFG, overrides=train_overrides(
        tmp_path / "run", data=DATA, raymarcher=TRAIN_RAYMARCHER, extra=[
            "model.uv_size=32", "loss.losses.mask_l1.tgt_key=image_mask"]))
    assert cfg.dataloader.batch_size == 1
    iteration, last = t_run_train.main(cfg, device="cpu")
    assert iteration == 2
    assert {f"loss_{k}" for k in CONFIG_LOSSES} | {"loss_total"} == set(last)
    assert all(np.isfinite(v) for v in last.values())
    assert len(summaries) == 1 and all(
        v.shape == (1, 3, IMG, IMG) and np.isfinite(v).all()
        for v in summaries[0].values())
    ckpts = tmp_path / "run" / "checkpoints"
    state = torch.load(ckpts / "000002.pt", weights_only=True)
    first = torch.load(ckpts / "000000.pt", weights_only=True)
    assert len(state["optimizer"]["param_groups"]) == 5
    # the geometry decays by lr * wd a step and nothing else (the
    # checkpoint at 0 is written after the first update)
    w = "geomdecoder.transdecoder.dec0.weight_v"
    np.testing.assert_allclose(state["model"][w].numpy(),
                               first["model"][w].numpy() * (1 - 5e-6),
                               rtol=1e-6)
    with open(tmp_path / "run" / "tb" / "scalars.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert {r["step"] for r in logged} == {0, 1}
