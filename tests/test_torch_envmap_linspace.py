"""Part of tests/test_torch_envmap.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import sampling as ts

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [101, 200, 24])
def test_linspace_matches_jnp(n):
    np.testing.assert_array_equal(ts.linspace(-4.0, 4.0, n).numpy(),
                                  np.asarray(jnp.linspace(-4.0, 4.0, n)))
    np.testing.assert_array_equal(ts.linspace(-1.0, 1.0, n).numpy(),
                                  np.asarray(jnp.linspace(-1.0, 1.0, n)))
