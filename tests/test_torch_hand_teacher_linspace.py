"""Part of tests/test_torch_hand_teacher.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.models import hand_teacher_mvp as tt

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_voxel_axis_matches_jnp_linspace(n):
    got = tt.linspace(-1.0, 1.0, n).numpy()
    ref = np.asarray(jnp.linspace(-1.0, 1.0, n))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
