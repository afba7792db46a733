"""Part of tests/test_torch_reduce_probe.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat_cuda
from goliath_tpu.ops import gsplat_pallas

torch.set_num_threads(1)


@pytest.mark.parametrize("f", [1, 3, 10, 16])
@pytest.mark.parametrize("m", ([1, 63, 1000])[1:2])
def test_cumsum_rows_plain_matches_pallas_kernel(m, f):
    """M ragged against the JAX kernel's block of 64 (one short block, one
    block less a row, 15 blocks and a part)."""
    x = np.random.RandomState(0).standard_normal((m, f)).astype(
        np.float32)
    ref = gsplat_pallas.cumsum_rows_pl(jnp.asarray(x), block=64,
                                       interpret=True)
    got = gsplat_cuda.cumsum_rows(torch.from_numpy(x))
    assert got.shape == (m, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
    with pytest.raises(ValueError, match="float32"):
        gsplat_cuda.cumsum_rows(torch.zeros(3, f, dtype=torch.int32))
