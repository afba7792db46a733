"""Parity of the port's RGCA eval path with the JAX package on the CPU, at
the configs/rgca_synthetic.yml size (uv 32, 64x64 images, n_embs 16).

``model.render.use_pallas`` selects the compositor's block window on both
sides: true the Pallas kernels' (interpreted on the JAX side), unset the
JAX XLA compositor's (the config's default). This config overflows
``max_pairs_per_tile`` (128 pairs per 16x16 tile), where the two windows
differ, so ``run_test`` is compared under both.

Tolerances: atol 1e-4 and rtol 1e-4 on the forward outputs (float32 on
both sides; the conv pyramids and the compositor sum in other orders),
except depth at rtol 5e-4: the model divides the composited depth (~400
here) by alpha clipped at 0.05, which multiplies the compositor's error by
up to 20 at faint edges. rtol 1e-4 on the loss means, which average those
outputs.
"""

import ast
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.config import load_from_config as t_load_from_config
from goliath_torch.convert import load_params, params_from_jax, save_params
from goliath_torch.ops import gsplat_cuda
from goliath_torch.scripts import run_test as t_run_test
from goliath_torch.test import to_device
from goliath_tpu import test as j_test_lib
from goliath_tpu.config import Config, load_config, load_from_config
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from goliath_tpu.ops import gsplat_pallas
from goliath_tpu.scripts import run_test as j_run_test

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
DEPTH_RTOL = 5e-4
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "rgca_synthetic.yml")
_PALLAS = "model.render.use_pallas=true"


def _data_kwargs():
    kw = dict(load_config(_CFG).test.data)
    kw.pop("synthetic")
    return kw


def _model_cfg(cfg):
    mc = Config.wrap(dict(cfg.model))
    mc.pop("cal")
    mc["learn_blur"] = False
    return mc


def test_autoencoder_forward_matches_jax(monkeypatch):
    """Batch of 2 (the port renders one sample at a time) through
    AutoEncoder(train=False) with the JAX init converted by
    params_from_jax."""
    monkeypatch.setattr(gsplat_pallas, "INTERPRET", True)
    cfg = load_config(_CFG, overrides=[_PALLAS])
    ds = JSyntheticDataset(**_data_kwargs())
    samples = [ds[i] for i in (0, 7)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]
             if not isinstance(samples[0][k], str)}
    jm = load_from_config(_model_cfg(cfg), assets=ds.static_assets)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init(jax.random.PRNGKey(0), jb)
    ref = jax.jit(lambda p: jm.apply(p, jb, train=False))(params)

    tm = t_load_from_config(_model_cfg(cfg), assets=ds.static_assets,
                            device="cpu")
    tm.module.load_state_dict(params_from_jax(jax.device_get(params)),
                              strict=True)
    with torch.no_grad():
        got = tm.apply(to_device(batch, torch.device("cpu")))
    for k in ("rgb", "alpha", "depth", "primpos", "color", "opacity",
              "primscale", "geom", "embs", "spec_nml", "diff_color"):
        assert tuple(got[k].shape) == ref[k].shape, k
        rtol = DEPTH_RTOL if k == "depth" else RTOL
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=rtol, err_msg=k)
    assert float(got["alpha"].max()) > 0.5  # the head was rendered


@pytest.mark.parametrize("window", ["pallas", "xla"])
def test_run_test_matches_jax(tmp_path, monkeypatch, capsys, window):
    """run_test.main of both packages under the same overrides. JAX's
    test.ckpt=null run initializes with PRNGKey(0); the port loads that
    init from a .pt file (it draws its own init otherwise, which no JAX
    run can reproduce), so both evaluate the same model on the same
    frames. "pallas" sets use_pallas (the Pallas kernels, interpreted);
    "xla" leaves it unset, the config's default (the XLA compositor)."""
    monkeypatch.setattr(gsplat_pallas, "INTERPRET", True)
    monkeypatch.chdir(tmp_path)
    overrides = ["test.ckpt=null", "test.vis_path=null"] + (
        [_PALLAS] if window == "pallas" else [])
    seen = {}
    j_test = j_test_lib.test

    def spy(model, loss_fn, data, config, params, **kw):
        seen["params"] = params
        return j_test(model, loss_fn, data, config, params, **kw)

    monkeypatch.setattr(j_test_lib, "test", spy)
    j_run_test.main(load_config(_CFG, overrides=overrides))
    ref = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])

    ckpt = tmp_path / "jax_init.pt"
    torch.save(params_from_jax(jax.device_get(seen["params"])), ckpt)
    launches = []
    monkeypatch.setattr(gsplat_cuda, "rasterize_tiled",
                        _recording(gsplat_cuda.rasterize_tiled, launches))
    got = t_run_test.main(
        t_load_config(_CFG, overrides=overrides[1:] + [
            f"test.ckpt={{ckpt_path: {ckpt}}}"]), device="cpu")
    assert set(launches) == {window}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)


def _recording(fn, windows):
    def wrapped(*a, **kw):
        windows.append(kw.get("window", "pallas"))
        return fn(*a, **kw)
    return wrapped


def test_run_test_own_init_and_checkpoints(tmp_path, monkeypatch):
    """test.ckpt=null draws the port's own seeded init; a .pt written by
    save_params reloads to the same losses; a directory that holds no
    checkpoint raises, naming the forms it takes (orbax among them)."""
    monkeypatch.chdir(tmp_path)
    vis = tmp_path / "viz"
    cfg = t_load_config(_CFG, overrides=["test.ckpt=null",
                                         f"test.vis_path={vis}"])
    frames = []
    means = t_run_test.main(cfg, device="cpu", frame_seconds=frames)
    assert len(frames) == 3 and len(os.listdir(vis)) == 3
    assert all(math.isfinite(v) for v in means.values())

    model = t_run_test.load_from_config(
        _model_cfg(cfg),
        assets=t_run_test.build_dataset(dict(cfg.test.data)).static_assets,
        device="cpu")
    path = tmp_path / "own.pt"
    save_params(str(path), model.module)
    again = t_run_test.main(t_load_config(_CFG, overrides=[
        f"test.ckpt={{ckpt_path: {path}}}", "test.vis_path=null"]),
        device="cpu")
    assert again == means
    with pytest.raises(ValueError, match="orbax"):
        load_params(model.module, str(tmp_path))
