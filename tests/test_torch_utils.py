"""Parity of the port's geometry, shading, SSIM, loss and config helpers with
the JAX package on the CPU.

Tolerances: integer and host-side numpy tables are compared exactly; float32
device math at atol 1e-5 / rtol 1e-5 (the same formulas on both sides, up to
the order of a few additions and the last ulp of transcendental functions);
SSIM at atol 1e-5 (sums of 11x11 window products); loss values at
atol 1e-4 (the primscale bound reaches ~1e2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch import config as tconfig
from goliath_torch import losses as tlosses
from goliath_torch.ops import sg as tsg
from goliath_torch.utils import geom as tgeom
from goliath_torch.utils import image as timage
from goliath_torch.utils import sampling as tsampling
from goliath_torch.utils import sh as tsh
from goliath_torch.utils import ssim as tssim
from goliath_tpu import losses as jlosses
from goliath_tpu.data.synthetic import make_sphere_mesh
from goliath_tpu.ops import sg as jsg
from goliath_tpu.utils import geom as jgeom
from goliath_tpu.utils import image as jimage
from goliath_tpu.utils import sampling as jsampling
from goliath_tpu.utils import sh as jsh
from goliath_tpu.utils import ssim as jssim

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol)


def test_geometry_module_matches_jax():
    v, vi, vt, vti = make_sphere_mesh(6, 9)
    jg = jgeom.GeometryModule(vi, vt, vti, None, uv_size=24, flip_uv=True)
    tg = tgeom.GeometryModule(vi, vt, vti, None, uv_size=24, flip_uv=True,
                              device="cpu")
    np.testing.assert_array_equal(tg.index_image_np, jg.index_image)
    np.testing.assert_array_equal(tg.bary_image_np, jg.bary_image)
    np.testing.assert_array_equal(tg.face_index_image_np, jg.face_index_image)
    np.testing.assert_array_equal(tgeom.compute_v2uv(len(v), vi, vti),
                                  jgeom.compute_v2uv(len(v), vi, vti))
    for a, b in zip(tgeom.compute_neighbours(len(v), vi),
                    jgeom.compute_neighbours(len(v), vi)):
        np.testing.assert_array_equal(a, b)

    rng = np.random.RandomState(0)
    verts = (v[None] + rng.randn(2, *v.shape) * 3.0).astype(np.float32)
    _close(tg.vn(torch.from_numpy(verts)), jg.vn(jnp.asarray(verts)))
    _close(tg.to_uv(torch.from_numpy(verts)), jg.to_uv(jnp.asarray(verts)),
           atol=1e-4)  # positions ~100: 1e-6 relative
    with pytest.raises(NotImplementedError, match="impaint"):
        tgeom.GeometryModule(vi, vt, vti, None, uv_size=8, impaint=True)


@pytest.mark.parametrize("mode,padding,align", [
    ("bilinear", "zeros", False), ("bilinear", "border", True),
    ("nearest", "zeros", False), ("nearest", "border", True)])
def test_grid_sample_matches_jax_and_torch(mode, padding, align):
    rng = np.random.RandomState(1)
    img = rng.rand(2, 3, 9, 11).astype(np.float32)
    grid = (rng.rand(2, 5, 7, 2) * 2.4 - 1.2).astype(np.float32)
    got = tsampling.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                                mode, padding, align)
    _close(got, jsampling.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                      mode, padding, align))
    if mode == "bilinear":  # torch's own op agrees too
        ref = torch.nn.functional.grid_sample(
            torch.from_numpy(img), torch.from_numpy(grid), mode, padding,
            align)
        _close(got, ref.numpy())


def test_sample_uv_matches_jax():
    rng = np.random.RandomState(2)
    uv = rng.rand(2, 3, 16, 16).astype(np.float32)
    coords = rng.rand(20, 2).astype(np.float32)
    v2uv = rng.randint(0, 20, (12, 4))
    _close(tgeom.sample_uv(torch.from_numpy(uv), torch.from_numpy(coords),
                           torch.from_numpy(v2uv)),
           jgeom.sample_uv(jnp.asarray(uv), jnp.asarray(coords),
                           jnp.asarray(v2uv)))


@pytest.mark.parametrize("deg", [1, 2, 3, 8])
def test_dir2sh_matches_jax(deg):
    d = np.random.RandomState(deg).randn(4, 5, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tsh.dir2sh(deg, torch.from_numpy(d)),
           jsh.dir2sh(deg, jnp.asarray(d)), atol=1e-4)  # P_8^m reaches ~1e3


@pytest.mark.parametrize("w_type", [0, 1, 2, 3])
def test_evaluate_gaussian_matches_jax(w_type):
    rng = np.random.RandomState(w_type)
    args = (rng.randn(2, 30, 3), 0.05 + rng.rand(2, 30),
            rng.rand(2, 4, 3), rng.randn(2, 4, 3) * 5.0, rng.randn(2, 30, 3))
    args = [a.astype(np.float32) for a in args]
    n_lights = np.array([1, 4], np.int32)
    got = tsg.evaluate_gaussian(*map(torch.from_numpy, args),
                                torch.from_numpy(n_lights), w_type=w_type)
    ref = jsg.evaluate_gaussian(*map(jnp.asarray, args),
                                jnp.asarray(n_lights), w_type=w_type)
    _close(got, ref, atol=1e-4)  # weights reach ~1e2 at sigma 0.05


def test_ssim_and_image_losses_match_jax():
    rng = np.random.RandomState(3)
    a = rng.rand(2, 3, 20, 24).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    m = (rng.rand(2, 1, 20, 24) > 0.3).astype(np.float32)
    _close(tssim.ssim(*map(torch.from_numpy, (a, b, m))),
           jssim.ssim(*map(jnp.asarray, (a, b, m))))
    _close(timage.erode(torch.from_numpy(m), 3),
           jimage.erode(jnp.asarray(m), 3))

    preds = {"rgb": b, "geom": rng.randn(2, 7, 3).astype(np.float32),
             "spec_dnml": rng.randn(2, 9, 3).astype(np.float32),
             "primscale_preclip": rng.rand(2, 9, 3).astype(np.float32) * 25,
             "diff_color": rng.randn(2, 9, 3).astype(np.float32)}
    targets = {"image": a, "image_weight": m,
               "registration_vertices": rng.randn(2, 7, 3).astype(np.float32)}
    cfg = {
        "rgb_l1": {"src_key": "rgb", "tgt_key": "image",
                   "mask_key": "image_weight", "weight": 10.0},
        "rgb_ssim": {"src_key": "rgb", "tgt_key": "image",
                     "mask_key": "image_weight", "weight": 0.2},
        "psnr": {"src_key": "rgb", "tgt_key": "image",
                 "mask_key": "image_weight", "weight": 0.0, "mask_erode": 3},
        "geom_l2": 0.4,
        "l2_reg": {"key": "spec_dnml", "schedule": {
            "class_name": "ca_code.loss.MonotonicWeightSchedule",
            "start": 0, "end": 10, "init_value": 1.0, "target_value": 0.0}},
        "bound_primscale": 0.01,
        "negcolor": 0.01,
    }
    jcfg = dict(cfg, l2_reg={**cfg["l2_reg"], "schedule": {
        **cfg["l2_reg"]["schedule"],
        "class_name": "goliath_tpu.losses.MonotonicWeightSchedule"}})
    for it in (0, 4, 20):
        jt, jd = jlosses.ModularLoss(jcfg)(
            {k: jnp.asarray(v) for k, v in preds.items()},
            {k: jnp.asarray(v) for k, v in targets.items()}, iteration=it)
        tt, td = tlosses.ModularLoss(cfg)(
            {k: torch.from_numpy(v) for k, v in preds.items()},
            {k: torch.from_numpy(v) for k, v in targets.items()},
            iteration=it)
        assert set(td) == set(jd)
        for k in jd:
            _close(td[k], jd[k], atol=1e-4)
    # a loss of a path that is not ported yet
    with pytest.raises(ValueError, match="not registered"):
        tlosses.ModularLoss({"rgb_l1_focus": 0.002})


def test_config_remaps_class_names_onto_the_port():
    assert (tconfig.load_class("goliath_tpu.losses.ModularLoss")
            is tlosses.ModularLoss)
    assert (tconfig.load_class("ca_code.loss.ModularLoss")
            is tlosses.ModularLoss)
    from goliath_torch.models.rgca import AutoEncoder

    assert tconfig.load_class("ca_code.models.rgca.AutoEncoder") is AutoEncoder


def test_quat_to_matrix_matches_jax():
    from goliath_torch.utils.quaternion import quat_to_matrix
    from goliath_tpu.utils.quaternion import quat_to_matrix as j_quat

    q = np.random.RandomState(4).randn(6, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    _close(quat_to_matrix(torch.from_numpy(q)), j_quat(jnp.asarray(q)))
