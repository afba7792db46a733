"""Part of tests/test_torch_body_utils.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.nn import shadow as tsh
from goliath_torch.utils import geom as tgeom, sampling as tsamp
from goliath_tpu.data import synthetic as jsyn
from goliath_tpu.nn import shadow as jsh
from goliath_tpu.utils import geom as jgeom, sampling as jsamp

from tests.test_torch_body_utils import _close, _module_outputs

torch.set_num_threads(1)


@pytest.mark.parametrize("biases,trainable", [(False, False), (True, True)])
def test_shadow_unet_matches_jax(biases, trainable):
    """AO at 64 resized to the 16 grid (by 4), the stored mean at 24
    nearest-resized to 16 on the host, output upsampled to 32."""
    rng = np.random.RandomState(2)
    ao_mean = rng.rand(1, 24, 24).astype(np.float32)
    ao = rng.rand(2, 1, 64, 64).astype(np.float32)
    kw = dict(uv_size=32, ao_mean=ao_mean, shadow_size=16, n_dims=4,
              biases=biases, trainable_mean=trainable)
    got, ref = _module_outputs(jsh.ShadowUNet(**kw), tsh.ShadowUNet(**kw),
                               ao)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])


def test_impaint_view_cos_and_depth_mask_match_jax():
    v, vi, vt, vti = jsyn.make_sphere_mesh(6, 9)
    idx = jgeom.make_uv_vert_index(vt, vi, vti, 32, flip_uv=False)
    fidx, bary = jgeom.make_uv_barys(vt, vti, 32, flip_uv=False)
    for args in ((idx, bary, 3.0), (fidx, None, 100.0)):
        got = tgeom.index_image_impaint(*args)
        ref = jgeom.index_image_impaint(*args)
        for a, b in zip(got if args[1] is not None else [got],
                        ref if args[1] is not None else [ref]):
            np.testing.assert_array_equal(a, b)

    rng = np.random.RandomState(6)
    verts = (v[None] + rng.randn(2, *v.shape) * 2.0).astype(np.float32)
    cam = (rng.randn(2, 3) * 300).astype(np.float32)
    _close(tgeom.compute_view_cos(torch.from_numpy(verts),
                                  torch.from_numpy(vi), torch.from_numpy(cam)),
           jax.jit(jgeom.compute_view_cos)(jnp.asarray(verts),
                                           jnp.asarray(vi), jnp.asarray(cam)))
    depth = (rng.rand(2, 1, 24, 30) * 20).astype(np.float32)
    depth[:, :, 8:16, 10:20] += 200.0  # a step of the Sobel's threshold size
    got = tgeom.depth_discontinuity_mask(torch.from_numpy(depth))
    ref = jax.jit(jgeom.depth_discontinuity_mask)(jnp.asarray(depth))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < float(got.float().mean()) < 1


@pytest.mark.parametrize("size,align", ([
    ((32, 32), False),   # down by 2 (encoder 1024 -> 512)
    ((16, 16), False),   # down by 4 (ShadowUNet AO 1024 -> 256)
    ((128, 96), False),  # up by 2 and by 1.5
    ((64, 64), True),    # the up blocks' align_corners
    ((21, 166), False),  # ratios that are no power of two (pixel bias)
])[4:5], ids=['size4-False'])
def test_interpolate_bilinear_matches_jax(size, align):
    x = np.random.RandomState(4).randn(2, 3, 64, 64).astype(np.float32)
    got = tsamp.interpolate_bilinear(torch.from_numpy(x), size=size,
                                     align_corners=align)
    _close(got, jsamp.interpolate_bilinear(jnp.asarray(x), size=size,
                                           align_corners=align))
    if not align and size == (32, 32):  # torch's own op agrees here
        _close(got, torch.nn.functional.interpolate(
            torch.from_numpy(x), size=size, mode="bilinear",
            align_corners=False))
