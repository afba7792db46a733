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
from goliath_torch.utils import geom as tgeom
from goliath_torch.utils import image as timage
from goliath_torch.utils import ssim as tssim
from goliath_tpu import losses as jlosses
from goliath_tpu.data.synthetic import make_sphere_mesh
from goliath_tpu.utils import geom as jgeom
from goliath_tpu.utils import image as jimage
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
    # impainted tables: every empty texel within the threshold takes its
    # nearest valid texel's entries, as in the JAX package
    ji = jgeom.GeometryModule(vi, vt, vti, None, uv_size=24, impaint=True,
                              impaint_threshold=3.0)
    ti = tgeom.GeometryModule(vi, vt, vti, None, uv_size=24, impaint=True,
                              impaint_threshold=3.0, device="cpu")
    np.testing.assert_array_equal(ti.index_image_np, ji.index_image)
    np.testing.assert_array_equal(ti.bary_image_np, ji.bary_image)
    np.testing.assert_array_equal(ti.face_index_image_np, ji.face_index_image)
    assert (ti.index_image_np != -1).sum() > (tg.index_image_np != -1).sum()
    _close(ti.to_uv(torch.from_numpy(verts)), ji.to_uv(jnp.asarray(verts)),
           atol=1e-4)


def test_sample_uv_matches_jax():
    rng = np.random.RandomState(2)
    uv = rng.rand(2, 3, 16, 16).astype(np.float32)
    coords = rng.rand(20, 2).astype(np.float32)
    v2uv = rng.randint(0, 20, (12, 4))
    _close(tgeom.sample_uv(torch.from_numpy(uv), torch.from_numpy(coords),
                           torch.from_numpy(v2uv)),
           jgeom.sample_uv(jnp.asarray(uv), jnp.asarray(coords),
                           jnp.asarray(v2uv)))


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
    # a loss that no package registers
    with pytest.raises(ValueError, match="not registered"):
        tlosses.ModularLoss({"no_such_loss_l1": 0.002})


def test_config_remaps_class_names_onto_the_port():
    assert (tconfig.load_class("goliath_tpu.losses.ModularLoss")
            is tlosses.ModularLoss)
    assert (tconfig.load_class("ca_code.loss.ModularLoss")
            is tlosses.ModularLoss)
    from goliath_torch.models.rgca import AutoEncoder

    assert tconfig.load_class("ca_code.models.rgca.AutoEncoder") is AutoEncoder
