"""Part of tests/test_torch_urhand_train.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.models import urhand as tu
from goliath_torch.nn.color_cal import CalV5 as TCalV5
from goliath_torch.scripts import run_train as t_run_train
from goliath_tpu.nn.color_cal import CalV5 as JCalV5

from tests.test_torch_urhand_train import CONFIG_LOSSES, _CFG, _train_overrides

torch.set_num_threads(1)


def test_cal_gradients_match_jax():
    """CalV5 alone on the identity camera, a grey camera (id prefix "41")
    and colour cameras, with random calibration parameters: the output and
    the gradients of the image and of the parameters, each scaled by its
    camera's learning-rate scale (the identity camera takes none)."""
    cameras = ("400000", "410001", "400002", "410003")
    rng = np.random.RandomState(5)
    image = (rng.rand(5, 3, 6, 7) * 255).astype(np.float32)
    up = rng.randn(5, 3, 6, 7).astype(np.float32)
    cam = np.asarray([0, 1, 2, 3, 2], np.int32)
    table = (rng.randn(4, 6) * 0.5 + [1, 1, 1, 0, 0, 0]).astype(np.float32)

    jcal = JCalV5(cameras=cameras, identity_camera="400000")

    def jf(p, img):
        return jnp.sum(jcal.apply({"params": {"cal_params": p}}, img,
                                  jnp.asarray(cam)) * jnp.asarray(up))

    ref_out = jcal.apply({"params": {"cal_params": jnp.asarray(table)}},
                         jnp.asarray(image), jnp.asarray(cam))
    ref_gp, ref_gi = jax.grad(jf, argnums=(0, 1))(jnp.asarray(table),
                                                  jnp.asarray(image))
    tcal = TCalV5(cameras=cameras, identity_camera="400000")
    with torch.no_grad():
        tcal.cal_params.copy_(torch.from_numpy(table))
    img = torch.from_numpy(image).requires_grad_()
    out = tcal(img, torch.from_numpy(cam))
    (out * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(tcal.cal_params.grad.numpy(), ref_gp,
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(img.grad.numpy(), ref_gi, rtol=1e-6,
                               atol=1e-6)
    g = tcal.cal_params.grad.numpy()
    assert not g[0].any() and g[1:].all()
    # the colour camera's rows take col_lrscale (0.1) of the plain gradient
    plain = (up[cam == 2] * image[cam == 2]).sum(axis=(0, 2, 3))
    np.testing.assert_allclose(g[2, :3], 0.1 * plain, rtol=1e-5)


def test_run_train_on_the_urhand_config(tmp_path, monkeypatch):
    """run_train.main on configs/urhand.yml at the small sizes on the CPU,
    at the config's batch 1 and with its five losses (the effnet ones on
    random features, asked for in the loss config): 2 steps, the summary
    at iteration 0, a checkpoint with both parameter groups' parameters,
    and the logged scalars."""
    for k in ("GOLIATH_TORCH_ALLOW_RANDOM_FEATURES",
              "GOLIATH_TORCH_EFFNET_NPZ"):
        monkeypatch.delenv(k, raising=False)
    summaries = []
    call = tu.URHandSummary.__call__
    monkeypatch.setattr(tu.URHandSummary, "__call__", lambda self, p, b: (
        summaries.append(call(self, p, b)) or summaries[-1]))
    cfg = t_load_config(_CFG, overrides=_train_overrides(tmp_path / "run"))
    assert cfg.dataloader.batch_size == 1
    iteration, last = t_run_train.main(cfg, device="cpu")
    assert iteration == 2
    assert {f"loss_{k}" for k in CONFIG_LOSSES} | {"loss_total"} == set(last)
    assert all(np.isfinite(v) for v in last.values())
    assert len(summaries) == 1
    assert set(summaries[0]) == {"render", "phys", "normals", "gt"}
    assert all(v.shape[0] == 1 and np.isfinite(v).all()
               for v in summaries[0].values())
    ckpts = tmp_path / "run" / "checkpoints"
    assert (ckpts / "latest").read_text() == "000002.pt"
    state = torch.load(ckpts / "000002.pt", weights_only=True)
    assert state["iteration"] == 2
    assert {"cal.cal_params", "decoder_relight.texmod1_0.weight_v"} <= set(
        state["model"])
    assert len(state["optimizer"]["param_groups"]) == 2
    with open(tmp_path / "run" / "tb" / "scalars.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert {r["step"] for r in logged} == {0, 1}
    assert {r["tag"] for r in logged if r["step"] == 1} >= {
        f"Losses/loss_{k}" for k in CONFIG_LOSSES}
