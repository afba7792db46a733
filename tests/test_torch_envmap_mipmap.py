"""Part of tests/test_torch_envmap.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import mipmap_sampler as tm, sampling as ts
from goliath_tpu.utils import mipmap_sampler as jm

from tests.test_torch_envmap import EXACT_TOL, close

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["integer", "between", "top_clip", "q1"])
def test_mipmap_grid_sample_matches_jax(case):
    rng = np.random.default_rng(15)
    q = 1 if case == "q1" else 4
    levels = [rng.random((2, 3, 16 >> i, 32 >> i)).astype(np.float32)
              for i in range(q)]
    grid = rng.uniform(-1.1, 1.1, (2, 5, 7, 2)).astype(np.float32)
    lvl = {"integer": rng.integers(0, q, (2, 5, 7)).astype(np.float32),
           "between": rng.uniform(-0.5, q - 1, (2, 5, 7)),
           "top_clip": np.full((2, 5, 7), q - 1 + 0.5),
           "q1": rng.uniform(-1, 2, (2, 5, 7))}[case].astype(np.float32)
    got = tm.mipmap_grid_sample([torch.from_numpy(x) for x in levels],
                                torch.from_numpy(grid), torch.from_numpy(lvl))
    ref = jm.mipmap_grid_sample([jnp.asarray(x) for x in levels],
                                jnp.asarray(grid), jnp.asarray(lvl))
    assert tuple(got.shape) == (2, 3, 5, 7)
    close(got, ref, EXACT_TOL, EXACT_TOL)
    if case == "top_clip":   # just below the top level: all of it
        top = ts.grid_sample(torch.from_numpy(levels[-1]),
                             torch.from_numpy(grid), padding_mode="border")
        torch.testing.assert_close(got, top, rtol=1e-5, atol=1e-5)
