"""Part of tests/test_torch_deep_shadow.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_torch.utils.sampling import grid_sample_3d
from goliath_tpu.ops import mvp as jm
from goliath_tpu.utils.sampling import grid_sample_3d as j_grid_sample_3d

from tests.test_torch_deep_shadow import (
    T,
    _GRID_CASES,
    _jax_drops,
    _scene,
    close,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", ([False, True])[1:2])
def test_grid_sample_3d_matches_jax(padding_mode, align_corners):
    """[C, D, H, W] volumes at coordinates reaching 0.4 outside [-1, 1]."""
    rng = np.random.RandomState(11)
    vol = rng.randn(3, 5, 6, 7).astype(np.float32)
    coords = ((rng.rand(4, 10, 3) - 0.5) * 2.8).astype(np.float32)
    ref = j_grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords),
                           padding_mode, align_corners)
    got = grid_sample_3d(T(vol), T(coords), padding_mode, align_corners)
    assert got.shape == (3, 4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("case", sorted(_GRID_CASES))
def test_splat_density_grid_matches_jax(case):
    c = _GRID_CASES[case]
    primpos, primrot, primscale, alpha = _scene(c["seed"], c["K"],
                                                spread=c["spread"])
    kw = dict(grid_res=c["G"], block=c["block"],
              max_prims_per_block=c["mppb"], chunk=c["chunk"])
    ref = np.asarray(jm.splat_density_grid(
        jnp.asarray(primpos), jnp.asarray(primrot), jnp.asarray(primscale),
        jnp.asarray(alpha), **kw))
    drops = {}
    got = tm.splat_density_grid(T(primpos), T(primrot), T(primscale),
                                T(alpha), drops=drops, **kw)
    assert got.shape == (c["G"],) * 3 and float(ref.max()) > 1.0
    close(got.numpy(), ref)
    expected = _jax_drops(primpos, primrot, primscale, c["G"], c["block"],
                          c["mppb"], c["chunk"])
    assert {k: int(drops[k]) for k in expected} == expected
    assert int(drops["pairs_wanted"]) == expected["pairs_binned"]
    if case == "all_kept":
        assert expected["blocks_full"] == 0
        assert expected["prims_kept"] == c["K"]
    else:
        assert expected["blocks_full"] > 0 and expected["prims_dropped"] > 0
