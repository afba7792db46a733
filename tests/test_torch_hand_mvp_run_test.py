"""Part of tests/test_torch_hand_mvp.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import params_from_jax
from goliath_torch.losses import perceptual as tp
from goliath_torch.models import hand_mvp as th
from goliath_torch.scripts import run_test as t_run_test
from goliath_torch.utils import geom as tg
from goliath_torch.utils.lbs import LBSModule
from goliath_tpu.config import load_config
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.models import hand_mvp as jh
from goliath_tpu.utils import geom as jg

from tests.test_torch_hand_mvp import RTOL, T, _CFG, _overrides, jax_eval
from tests.test_torch_mesh_vae import close_to_scale, jitter_template
from tests.test_torch_perceptual import clear_jax_features, jax_feature_files

torch.set_num_threads(1)


def test_primitive_bases_match_jax():
    """init_primitives exactly; make_postex, compute_tbn and the frames'
    identity fallback on the posed sphere as it is (its pole frames are
    zero: they fall back in both packages)."""
    ds = SyntheticDataset(n_cams=2, n_frames=2, img_h=48, img_w=48,
                          uv_size=64, seed=1)
    topo = ds.static_assets.topology
    args = (np.asarray(topo.vi), np.asarray(topo.vt), np.asarray(topo.vti),
            np.asarray(topo.v2uv))
    jgeo = jg.GeometryModule(*args, uv_size=64)
    tgeo = tg.GeometryModule(*args, uv_size=64, device="cpu")
    ref_tables = jh.init_primitives(64, 64, jgeo)
    got_tables = th.init_primitives(64, 64, tgeo)
    for g, r in zip(got_tables, ref_tables):
        np.testing.assert_array_equal(g, np.asarray(r))
    vidx, vtidx, bary = ref_tables

    pose = ds.get(0, 0)["pose"][None]
    assets = ds.static_assets
    lbs = LBSModule(assets.lbs_model_json, assets.lbs_config_dict,
                    np.asarray(assets.template_mesh_unscaled)[None],
                    assets.skeleton_scales, [1.0] * 3, device="cpu")
    geom = lbs.pose(torch.zeros((1,) + tuple(
        lbs.lbs_template_verts.shape[-2:])), torch.from_numpy(pose))
    jgeom = jnp.asarray(geom.numpy())
    close_to_scale(tg.make_postex(geom, T(vidx), T(bary)).numpy(),
                   jg.make_postex(jgeom, jnp.asarray(vidx),
                                  jnp.asarray(bary)))
    ref_tbn = jg.compute_tbn(jgeom, jnp.asarray(jgeo.vt), jnp.asarray(vidx),
                             jnp.asarray(vtidx))
    got_tbn = tg.compute_tbn(geom, tgeo.vt, T(vidx), T(vtidx))
    for g, r in zip(got_tbn, ref_tbn):
        r = np.asarray(r)
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g.numpy()), fin)
        close_to_scale(g.numpy()[fin], r[fin])
    # the JAX GeomDecoder's fallback, eagerly
    base = jnp.stack(ref_tbn, axis=-2).reshape(1, 64, 3, 3).transpose(
        0, 1, 3, 2)
    ref_fallback = np.asarray(jnp.abs(jnp.linalg.det(base)) < 0.5)
    _, rot, fallback = th.prim_bases(geom, tgeo.vt, T(vidx), T(vtidx),
                                     T(bary))
    np.testing.assert_array_equal(fallback.numpy(), ref_fallback)
    assert 0 < int(fallback.sum()) < 64   # the pole rows fall back
    np.testing.assert_array_equal(rot.numpy()[fallback.numpy()],
                                  np.broadcast_to(np.eye(3), (int(
                                      fallback.sum()), 3, 3)))


def test_hand_mvp_run_test_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mp = pytest.MonkeyPatch()
    try:
        files = jax_feature_files(tmp_path, mp, nets=("vgg",))
        ref, params = jax_eval(load_config(_CFG, overrides=_overrides()))
    finally:
        mp.undo()
        clear_jax_features()

    build = t_run_test.build_dataset
    monkeypatch.setattr(t_run_test, "build_dataset",
                        lambda cfg, **kw: jitter_template(build(cfg, **kw)))
    monkeypatch.setenv(tp.VGG19_ENV, files["vgg"])
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
        "loss_rgb_l2", "loss_vgg", "loss_mask_l1", "loss_alphaprior",
        "loss_primvolsum", "loss_psnr", "loss_total"}
    assert all(np.isfinite(v) for v in got.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
