"""Part of tests/test_torch_utils.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import sg as tsg
from goliath_tpu.ops import sg as jsg

from tests.test_torch_utils import _close

torch.set_num_threads(1)


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
