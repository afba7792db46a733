"""The checkpoint-render example (goliath_torch/examples/render_example.py)
against the JAX package's examples/render_example.py on the CPU, on
configs/rgca_synthetic.yml as it stands (64x64, uv 32, 4 samples).

The JAX package's ``save_checkpoint`` writes one orbax checkpoint of the
port's seeded initialization of the training model (``cal`` and
``learn_blur`` included, which both examples drop), put into the flax tree
by name. Both scripts' ``main`` (argv patched) read it; their PNGs agree
within 1 LSB of uint8 (the grids truncate float32 renders that differ by
rounding). At its initialization the model renders next to nothing (0.4%
of the grid's pixels above 0, none above 8), so the comparison is made
again on ``visible`` weights: the initialization with the last decoder
layer's untied biases shifted, the Gaussians' scales (softplus) by +3, their
opacity logit by +2 and the three DC diffuse colour coefficients by +3
(then 65% of the pixels are above 0). The port's ``main`` also reads its own ``.pt`` file and its own
checkpoint directory of the same weights, and writes the same PNG bit for
bit. The body models' branch (rgb in 0..255, divided by 255) runs on a
small cut of configs/mesh_vae.yml, port only: its PNG is the grid of the
returned model's forward on the returned batch, bit for bit.

The JAX script's model is wrapped: ``init`` by ``jax.eval_shape`` (the
restored parameters replace it) and ``apply`` by ``jax.jit``.
"""

import functools
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from goliath_torch import train as t_train
from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import save_params
from goliath_torch.examples import render_example as t_example
from goliath_tpu import train as j_train
from tests.test_torch_quality import flax_tree, port_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "rgca_synthetic.yml")
MESH_CFG = os.path.join(ROOT, "configs", "mesh_vae.yml")


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_render_example", os.path.join(ROOT, "examples",
                                           "render_example.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jitted(build):
    def wrapped(*a, **kw):
        model = build(*a, **kw)
        init, apply = model.init, model.apply
        model.init = lambda rng, batch: jax.eval_shape(init, rng, batch)
        model.apply = lambda params, batch, train=False: jax.jit(
            functools.partial(apply, train=train))(params, batch)
        return model
    return wrapped


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


_RENDER = t_example.render


def _run_port_main(monkeypatch, *argv):
    """The port's main on argv, its render on the CPU."""
    monkeypatch.setattr(sys, "argv", ["render_example", *argv])
    monkeypatch.setattr(t_example, "render",
                        functools.partial(_RENDER, device="cpu"))
    t_example.main()


# channels of decoder.vnocond1 (the last layer of the view-independent
# pyramid): 17 diffuse SH coefficients (4 per colour, then 5 mono), then
# position 3, rotation 4, scale 3, opacity 1, then sigma
SHIFTS = {(24, 25, 26): 3.0, (27,): 2.0, (0, 4, 8): 3.0}


def write_weights(ckpt_dir, visible):
    """The port's seeded training model of CFG (``visible``: its biases
    shifted by SHIFTS) as an orbax checkpoint directory of the JAX
    package's save_checkpoint; returns its state_dict."""
    module = port_model(t_load_config(CFG)).module
    if visible:
        with torch.no_grad():
            for chans, shift in SHIFTS.items():
                module.decoder.vnocond1.bias[list(chans)] += shift
    state = module.state_dict()
    j_train.save_checkpoint(ckpt_dir, {"model": {"params": flax_tree(state)}},
                            iteration=3)
    return state


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("orbax") / "checkpoints")
    return ckpt_dir, write_weights(ckpt_dir, visible=True)


@pytest.mark.parametrize("visible", [False, True])
def test_examples_agree_from_one_orbax_checkpoint(visible, tmp_path,
                                                  monkeypatch, capsys):
    ckpt_dir = str(tmp_path / "checkpoints")
    write_weights(ckpt_dir, visible)
    jex = _jax_example()
    monkeypatch.setattr(jex, "load_from_config", _jitted(
        jex.load_from_config))
    j_png, t_png = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    monkeypatch.setattr(sys, "argv", ["render_example.py", CFG, ckpt_dir,
                                      j_png])
    jex.main()
    _run_port_main(monkeypatch, CFG, ckpt_dir, t_png)
    out = capsys.readouterr().out
    assert f"wrote {t_png} (256x64)" in out and f"wrote {j_png}" in out
    got, ref = _png(t_png), _png(j_png)
    assert got.shape == ref.shape == (64, 256, 3)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, (int(diff.max()), int((diff > 1).sum()))
    assert (ref > 0).mean() > (0.5 if visible else 0.001)


def test_example_reads_the_ports_checkpoints(weights, tmp_path, monkeypatch):
    """The same weights as the port's .pt file and its checkpoint directory:
    the PNG of the orbax checkpoint bit for bit."""
    ckpt_dir, state = weights
    pt = str(tmp_path / "params.pt")
    module = port_model(t_load_config(CFG)).module
    module.load_state_dict(state)
    save_params(pt, module)
    t_train.save_checkpoint(str(tmp_path / "run"), {"model": state},
                            iteration=5)
    pngs = []
    for ckpt in (ckpt_dir, pt, str(tmp_path / "run")):
        pngs.append(str(tmp_path / f"{len(pngs)}.png"))
        _run_port_main(monkeypatch, CFG, ckpt, pngs[-1])
    for path in pngs[1:]:
        np.testing.assert_array_equal(_png(path), _png(pngs[0]))


def test_example_body_model_branch(tmp_path):
    small = {
        "data": {"synthetic": True, "img_h": 48, "img_w": 48, "uv_size": 64,
                 "n_cams": 2, "n_frames": 3, "seed": 2},
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
    }
    cfg = t_load_config(MESH_CFG, overrides=[
        f"{k}={json.dumps(v)}" for k, v in small.items()])
    out = str(tmp_path / "mesh.png")
    res = t_example.render(cfg, out_path=out, device="cpu")
    assert res["batch"]["image"].shape[0] == 4   # min(4, 2 x 3 samples)
    with torch.no_grad():
        rgb = res["model"].apply(res["batch"], train=False)["rgb"]
    assert float(rgb.max()) > 2.0   # the body model's 0..255
    want = t_example.to_uint8_grid(rgb.numpy())
    assert want.shape == (48, 192, 3)
    np.testing.assert_array_equal(res["grid"], want)
    np.testing.assert_array_equal(_png(out), want)
    assert not hasattr(res["model"].module, "pixel_cal") or \
        res["model"].module.pixel_cal is None
