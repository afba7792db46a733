"""Part of tests/test_torch_envmap.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import envmap as te, hdr as th
from goliath_tpu.utils import envmap as je, hdr as jh

from tests.test_torch_envmap import EXACT_TOL, close, unit

torch.set_num_threads(1)


@pytest.mark.parametrize("ext", [".npy", ".npz"])
def test_load_envmap_arrays_match_jax(tmp_path, ext):
    img = np.random.default_rng(5).random((6, 12, 3))   # float64 on disk
    path = tmp_path / f"env{ext}"
    if ext == ".npy":
        np.save(path, img)
    else:
        np.savez(path, envmap=img)
    got, ref = th.load_envmap(str(path)), jh.load_envmap(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_dir2uv_matches_jax_at_the_poles_and_the_seam():
    rng = np.random.default_rng(8)
    d = unit(rng, (2, 3, 5, 7), 1)
    d[0, :, 0, 0] = [0.0, 1.0, 0.0]      # the poles: y = +-1
    d[0, :, 0, 1] = [0.0, -1.0, 0.0]
    d[0, :, 1, 0] = [0.0, 1.0 + 1e-7, 0.0]   # past 1: the clip
    d[1, :, 0, 0] = [0.0, 0.6, 0.0]      # x = z = 0 off the poles
    d[1, :, 0, 1] = [-0.0, 0.3, -1.0]    # on the seam
    d[1, :, 0, 2] = [1e-30, 0.0, -1.0]
    got = te.dir2uv(torch.from_numpy(d), 1)
    ref = je.dir2uv(jnp.asarray(d), 1)
    # v = 2 acos(y) / pi - 1 cancels near the equator: an ulp of 2 acos /
    # pi (~1) survives as an absolute error there
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=2 * np.finfo(np.float32).eps)
    last = te.dir2uv(torch.from_numpy(np.moveaxis(d, 1, -1)), -1)
    np.testing.assert_array_equal(last.numpy(), got.numpy())


def test_sphere_dirs_match_jax():
    close(te._sphere_dirs(9, 18), je._sphere_dirs(9, 18), EXACT_TOL,
          EXACT_TOL)
