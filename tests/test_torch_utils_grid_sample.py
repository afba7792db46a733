"""Part of tests/test_torch_utils.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import sampling as tsampling
from goliath_tpu.utils import sampling as jsampling

from tests.test_torch_utils import _close

torch.set_num_threads(1)


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
