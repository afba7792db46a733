"""Parity of goliath_torch.ops.binning (and K4's plain version) with the JAX
reference goliath_tpu.ops.binning on the CPU.

Tolerance: none. Binning is integer work, so every field must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import binning as tb
from goliath_torch.ops.gsplat_cuda import cumsum1d, cumsum1d_plain
from goliath_tpu.ops import binning as jb
from goliath_tpu.ops.gsplat_pallas import cumsum1d_pl

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

_FIELDS = ("sorted_prim", "tile_start", "tile_end", "perm", "prim_offsets",
           "prim_ends", "tile_of_pair")


def _boxes(rng, N, ntx, nty, max_span):
    lo = np.stack([rng.randint(-3, ntx + 1, N), rng.randint(-3, nty + 1, N)],
                  -1).astype(np.int32)
    span = rng.randint(0, max_span + 1, (N, 2)).astype(np.int32)
    valid = rng.rand(N) > 0.15
    qd = rng.randint(0, 1 << 12, N).astype(np.int32)
    return lo, lo + span, valid, qd


@pytest.mark.parametrize("with_depth,budget_mult", [
    (True, 4), (False, 4), (True, 1)])   # budget 1x N forces overflow
def test_bin_to_tiles_matches_jax(with_depth, budget_mult):
    rng = np.random.RandomState(3)
    N, ntx, nty, K = 300, 9, 7, 16
    lo, hi, valid, qd = _boxes(rng, N, ntx, nty, max_span=8)
    budget = budget_mult * N
    ref = jb.bin_to_tiles(jnp.asarray(lo), jnp.asarray(hi),
                          jnp.asarray(valid), ntx, nty, K, budget,
                          jnp.asarray(qd) if with_depth else None)
    got = tb.bin_to_tiles(torch.from_numpy(lo), torch.from_numpy(hi),
                          torch.from_numpy(valid), ntx, nty, K, budget,
                          torch.from_numpy(qd) if with_depth else None)
    assert (got.num_tiles_x, got.num_tiles_y) == (ntx, nty)
    for name in _FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name)


def test_cumsum1d_plain_matches_pallas_interpret():
    """Below 2^24 the TPU kernel's f32 carry is exact, so K4's plain version
    equals it exactly. The array spans several 512x128 kernel blocks."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, 150_000).astype(np.int32)
    ref = np.asarray(cumsum1d_pl(jnp.asarray(x), interpret=True)
                     ).astype(np.int32)
    got = cumsum1d(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(cumsum1d_plain(torch.from_numpy(x)).numpy(),
                                  np.cumsum(x).astype(np.int32))
