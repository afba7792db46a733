"""Parity of the port's MVP raymarcher (goliath_torch/ops/mvp.py,
ops/raygen.py, utils/render_raymarcher.py) with the JAX package on the CPU,
on tests/test_mvp.py's scenes (K 6-12 random boxes, 16x16 to 32x32 rays),
the same numpy-seeded inputs through both packages: ray generation,
trilinear sampling with and without a warp field, the all-prims oracle,
the tile-culled march with every one of its drops made to occur (each
asserted from the port's ``drops`` counts), and the Raymarcher at B = 1
and 2 with ``window_overflow``. The JAX oracle and tiled marches run under
``jax.jit`` (eagerly they take ~10x longer).

Tolerances: rtol 1e-5 plus 1e-6 of the output's largest |value| on ray
generation, samples and the oracle; the marches' rgba at rtol 1e-5 plus
2e-5 of the largest |value| (measured: the two packages are each ~5e-6
from a float64 march of the port and 9.6e-6 apart at an alpha of 0.87,
float32 cumsums over 100 steps and deposits summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_torch.ops import raygen as tr
from goliath_tpu.ops import mvp as jm
from goliath_tpu.ops import raygen as jr

torch.set_num_threads(1)

RTOL, OF_SCALE = 1e-5, 1e-6
MARCH_OF_SCALE = 2e-5


def close(got, ref, of_scale=OF_SCALE, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL,
                               atol=of_scale * float(np.abs(ref).max()),
                               err_msg=err_msg)


def T(a):
    return torch.from_numpy(np.array(a))


def _rotations(rng, K):
    """Random rotation matrices from normalized quaternions (w, x, y, z)."""
    q = rng.randn(K, 4)
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(K, 3, 3).astype(np.float32)


def _scene(seed, K=12, TD=4):
    rng = np.random.RandomState(seed)
    primpos = ((rng.rand(K, 3) - 0.5) * 1.2).astype(np.float32)
    primrot = _rotations(rng, K)
    primscale = (2.0 + 3.0 * rng.rand(K, 3)).astype(np.float32)
    template = rng.rand(K, 4, TD, TD, TD).astype(np.float32)
    template[:, 3] *= 30.0  # enough alpha to saturate some rays
    return primpos, primrot, primscale, template


def _camera(H, W):
    viewpos = np.asarray([[0.0, 0.0, -3.0]], np.float32)
    viewrot = np.eye(3, dtype=np.float32)[None]
    focal = np.asarray([[30.0, 30.0]], np.float32)
    princpt = np.asarray([[W / 2, H / 2]], np.float32)
    return viewpos, viewrot, focal, princpt


def _rays(H=32, W=32):
    """The JAX package's rays of tests/test_mvp.py, as numpy arrays."""
    viewpos, viewrot, focal, princpt = _camera(H, W)
    rp, rd, tminmax = jr.compute_raydirs(
        *(jnp.asarray(a) for a in (viewpos, viewrot, focal, princpt)),
        jr.make_pixelcoords(1, H, W), volradius=1.0)
    K_cam = np.asarray([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]],
                       np.float32)
    Rt = np.concatenate([viewrot[0], -viewrot[0] @ viewpos[0][:, None]], 1)
    return (np.asarray(rp[0]), np.asarray(rd[0]), np.asarray(tminmax[0]),
            K_cam, Rt.astype(np.float32))


def test_raygen_matches_jax():
    H, W = 24, 40
    cam = _camera(H, W)
    rng = np.random.RandomState(3)
    viewrot = _rotations(rng, 2)
    viewpos = rng.randn(2, 3).astype(np.float32) * 500.0
    focal = np.asarray([[30.0, 35.0], [50.0, 45.0]], np.float32)
    princpt = np.asarray([[W / 2, H / 2], [W / 3, H / 4]], np.float32)
    np.testing.assert_array_equal(
        tr.make_pixelcoords(2, H, W).numpy(),
        np.asarray(jr.make_pixelcoords(2, H, W)))
    for args, volradius in (((*cam,), 1.0),
                            ((viewpos, viewrot, focal, princpt), 400.0)):
        n = args[0].shape[0]
        ref = jr.compute_raydirs(*(jnp.asarray(a) for a in args),
                                 jr.make_pixelcoords(n, H, W), volradius)
        got = tr.compute_raydirs(*(T(a) for a in args),
                                 tr.make_pixelcoords(n, H, W), volradius)
        for name, g, r in zip(("raypos", "raydir", "tminmax"), got, ref):
            close(g.numpy(), r, err_msg=name)


def test_ray_box_spans_match_jax():
    """Entry and exit of rays through boxes, ungrouped and grouped, with
    ray directions that have exact zero components."""
    rng = np.random.RandomState(7)
    rp = rng.randn(2, 9, 3).astype(np.float32)
    rd = rng.randn(2, 9, 3).astype(np.float32)
    rd[:, :3, 1] = 0.0
    lo = rng.randn(2, 5, 3).astype(np.float32)
    hi = lo + rng.rand(2, 5, 3).astype(np.float32)
    for g, r in zip(tm._ray_box_span_g(T(rp), T(rd), T(lo), T(hi)),
                    jm._ray_box_span_g(*(jnp.asarray(a)
                                         for a in (rp, rd, lo, hi)))):
        close(g.numpy(), r)
    for g, r in zip(tm._ray_box_span(T(rp[0]), T(rd[0]), T(lo[0]), T(hi[0])),
                    jm._ray_box_span(*(jnp.asarray(a[0])
                                       for a in (rp, rd, lo, hi)))):
        close(g.numpy(), r)


def test_march_reference_matches_jax():
    primpos, primrot, primscale, template = _scene(0)
    rp, rd, tminmax, _, _ = _rays()
    args = (rp.reshape(-1, 3), rd.reshape(-1, 3), 0.05,
            tminmax.reshape(-1, 2), primpos, primrot, primscale, template)
    ref = np.asarray(jax.jit(jm.march_reference, static_argnums=(2, 8))(
        *(a if isinstance(a, float) else jnp.asarray(a) for a in args), 100))
    got = tm.march_reference(
        *(a if isinstance(a, float) else T(a) for a in args), 100).numpy()
    assert ref[:, 3].max() > 0.5   # the scene is visible
    close(got, ref)


def _tiled(pkg, scene, rays, stepsize, drops=None, **kw):
    primpos, primrot, primscale, template = scene
    rp, rd, tminmax, K_cam, Rt = rays
    arrays = (rp, rd, tminmax, primpos, primrot, primscale, template, K_cam,
              Rt)
    if pkg is jm:
        return np.asarray(jax.jit(lambda *a: jm.mvp_raymarch_tiled(
            a[0], a[1], stepsize, *a[2:], **kw))(
                *(jnp.asarray(x) for x in arrays)))
    a = [T(x) for x in arrays]
    return tm.mvp_raymarch_tiled(a[0], a[1], stepsize, *a[2:], drops=drops,
                                 **kw).numpy()


# (march keywords, the drops the port must count) on the scene of seed 0
MARCH_CASES = {
    "exact": (dict(max_steps=100, max_prims_per_tile=16, chunk=8), ()),
    "window": (dict(max_steps=100, max_prims_per_tile=16, chunk=8,
                    window_steps=48), ()),
    "drops": (dict(max_steps=100, max_prims_per_tile=4, chunk=2,
                   max_prims_per_ray=2, window_steps=6, max_tiles_per_prim=2,
                   pair_budget_mult=1),
              ("prims_clipped", "prims_dropped", "prims_cut", "tiles_full",
               "pairs_past_list", "rays_over_r", "window_cut_pairs",
               "window_cut_prims")),
    "step_cap": (dict(max_steps=12, max_prims_per_tile=16, chunk=8,
                      max_prims_per_ray=8),
                 ("rays_step_capped", "rays_over_r")),
}


def test_march_refuses_r_not_a_multiple_of_the_chunk():
    with pytest.raises(ValueError, match="multiple of chunk"):
        _tiled(tm, _scene(0), _rays(16, 16), 0.1, max_steps=20,
               max_prims_per_tile=8, chunk=3)
