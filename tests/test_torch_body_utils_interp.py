"""Part of tests/test_torch_body_utils.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import sampling as tsamp
from goliath_tpu.utils import sampling as jsamp

from tests.test_torch_body_utils import _close

torch.set_num_threads(1)


@pytest.mark.parametrize("size,align", ([
    ((32, 32), False),   # down by 2 (encoder 1024 -> 512)
    ((16, 16), False),   # down by 4 (ShadowUNet AO 1024 -> 256)
    ((128, 96), False),  # up by 2 and by 1.5
    ((64, 64), True),    # the up blocks' align_corners
    ((21, 166), False),  # ratios that are no power of two (pixel bias)
])[0:4])
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
