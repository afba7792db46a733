"""Part of tests/test_torch_deep_shadow.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_torch.utils.sampling import grid_sample_3d
from goliath_tpu.ops import mvp as jm
from goliath_tpu.utils.sampling import grid_sample_3d as j_grid_sample_3d

from tests.test_torch_deep_shadow import T, _LIGHTS, close, shadow_scene

torch.set_num_threads(1)


def test_shadow_at_points_exact_matches_jax(shadow_scene):
    """The per-prim oracle, 300 voxel centres at 24 steps."""
    (primpos, primrot, primscale, alpha), _, pts = shadow_scene
    pts = pts[::5][:300]
    lp = np.asarray(_LIGHTS["inside"], np.float32)
    ref = np.asarray(jm.shadow_at_points_exact(
        jnp.asarray(primpos), jnp.asarray(primrot), jnp.asarray(primscale),
        jnp.asarray(alpha), jnp.asarray(pts), jnp.asarray(lp), 24,
        point_chunk=128))
    got = tm.shadow_at_points_exact(T(primpos), T(primrot), T(primscale),
                                    T(alpha), T(pts), T(lp), 24)
    assert 0.05 < float(ref.mean()) < 0.95
    close(got.numpy(), ref, scale=1.0)


def test_shadow_volume_blocks_light():
    """tests/test_hand_teacher.py's occlusion check on the port alone: one
    opaque box at the origin; a point behind it (from the light) is
    shadowed, a point beside it is not."""
    density = tm.splat_density_grid(
        torch.zeros(1, 3), torch.eye(3)[None], torch.full((1, 3), 4.0),
        torch.full((1, 4, 4, 4), 40.0), 32)
    light = torch.tensor([0.0, 0.0, -0.9])
    pts = torch.tensor([[0.0, 0.0, 0.5], [0.8, 0.0, 0.5]])
    s = tm.shadow_at_points(density, pts, light, n_steps=48)
    assert s[0] > 0.9, f"occluded point not shadowed: {s}"
    assert s[1] < 0.1, f"unoccluded point shadowed: {s}"


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", ([False, True])[0:1])
def test_grid_sample_3d_matches_jax(padding_mode, align_corners):
    """[C, D, H, W] volumes at coordinates reaching 0.4 outside [-1, 1]."""
    rng = np.random.RandomState(11)
    vol = rng.randn(3, 5, 6, 7).astype(np.float32)
    coords = ((rng.rand(4, 10, 3) - 0.5) * 2.8).astype(np.float32)
    ref = j_grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords),
                           padding_mode, align_corners)
    got = grid_sample_3d(T(vol), T(coords), padding_mode, align_corners)
    assert got.shape == (3, 4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))
