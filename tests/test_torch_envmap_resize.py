"""Part of tests/test_torch_envmap.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import numpy as np
import pytest
import torch

from goliath_torch.utils import hdr as th
from goliath_tpu.utils import hdr as jh

torch.set_num_threads(1)


@pytest.mark.parametrize("src,dst", [((64, 128), (16, 32)),
                                     ((48, 100), (16, 32)),
                                     ((20, 40), (512, 1024))])
def test_resize_area_matches_jax(src, dst):
    img = np.random.default_rng(6).random(src + (3,)).astype(np.float32)
    got, ref = th.resize_area(img, *dst), jh.resize_area(img, *dst)
    assert got.shape == dst + (3,)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
