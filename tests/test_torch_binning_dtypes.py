"""Part of tests/test_torch_binning.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import pytest
import torch

from goliath_torch.ops.gsplat_cuda import cumsum1d

torch.set_num_threads(1)


def test_cumsum1d_rejects_other_dtypes():
    with pytest.raises(ValueError):
        cumsum1d(torch.zeros(4, dtype=torch.int64))
