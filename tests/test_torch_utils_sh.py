"""Part of tests/test_torch_utils.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import sh as tsh
from goliath_tpu.utils import sh as jsh

from tests.test_torch_utils import _close

torch.set_num_threads(1)


@pytest.mark.parametrize("deg", [1, 2, 3, 8])
def test_dir2sh_matches_jax(deg):
    d = np.random.RandomState(deg).randn(4, 5, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tsh.dir2sh(deg, torch.from_numpy(d)),
           jsh.dir2sh(deg, jnp.asarray(d)), atol=1e-4)  # P_8^m reaches ~1e3
