"""Part of tests/test_torch_hand_teacher.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import ast

import jax
import numpy as np
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import params_from_jax
from goliath_torch.scripts import run_test as t_run_test
from goliath_tpu.config import load_config

from tests.test_torch_hand_mvp import jax_eval
from tests.test_torch_hand_teacher import RTOL, _CFG, _overrides, both
from tests.test_torch_mesh_vae import close_to_scale, jitter_template

torch.set_num_threads(1)


@pytest.mark.parametrize("key", ([
    "rgb", "alpha", "primrgb", "primshadow", "mvp_window_overflow",
    "primpos", "primalpha"])[4:7])
def test_hand_teacher_forward_matches_jax(both, key):
    got, ref = both["got"], both["ref"]
    assert set(got) == set(ref)
    g, r = got[key].numpy(), np.asarray(ref[key])
    assert g.shape == r.shape and np.isfinite(g).all()
    close_to_scale(g, r, err_msg=key)
    if key in ("alpha", "primshadow"):
        assert float(r.max()) > 0.01   # the hand is visible, shadowed


def test_hand_teacher_run_test_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ref, params = jax_eval(load_config(_CFG, overrides=_overrides()))

    build = t_run_test.build_dataset
    monkeypatch.setattr(t_run_test, "build_dataset",
                        lambda cfg, **kw: jitter_template(build(cfg, **kw)))
    ckpt = tmp_path / "jax_init.pt"
    torch.save(params_from_jax(jax.device_get(params)), ckpt)
    frames = []
    got = t_run_test.main(t_load_config(_CFG, overrides=_overrides()[:-3] + [
        f"test.ckpt={{ckpt_path: {ckpt}}}", "test.vis_path=null",
        "test.n_test_frames=3"]), device="cpu", frame_seconds=frames)
    assert ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert len(frames) == 3
    assert set(got) == set(ref) == {
        "loss_rgb_l2", "loss_mask_l1", "loss_psnr", "loss_total"}
    assert all(np.isfinite(v) for v in got.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
