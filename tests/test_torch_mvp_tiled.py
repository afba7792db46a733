"""Part of tests/test_torch_mvp.py's tests, in a file of their own: a port test
file that runs long holds at most four tests, so that pytest-xdist's --dist
loadfile queues it after tests/test_tile_shard.py. The inputs, helpers and
tolerances are that file's. Each case also holds K8's plain version on the
same scene (tests/test_torch_mvp_kernel.py ``hold_kernel_route``).
"""

import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import (
    MARCH_CASES,
    MARCH_OF_SCALE,
    _rays,
    _scene,
    _tiled,
    close,
)
from tests.test_torch_mvp_kernel import hold_kernel_route

torch.set_num_threads(1)


@pytest.mark.parametrize("case", sorted(MARCH_CASES))
def test_tiled_march_matches_jax(case):
    kw, expected = MARCH_CASES[case]
    scene, rays = _scene(0), _rays()
    ref = _tiled(jm, scene, rays, 0.05, **kw)
    drops = {}
    got = _tiled(tm, scene, rays, 0.05, drops=drops, **kw)
    assert got.shape == ref.shape == (4, 32, 32)
    assert ref[3].max() > 0.5
    close(got, ref, MARCH_OF_SCALE)
    counts = {k: int(v) for k, v in drops.items()}
    assert counts["tiles_marched"] == 4 and counts["pair_budget"] == \
        kw.get("pair_budget_mult", 8) * 12
    for key in ("prims_clipped", "prims_dropped", "prims_cut", "tiles_full",
                "pairs_past_list", "rays_over_r", "window_cut_pairs",
                "window_cut_prims", "rays_step_capped"):
        assert (counts[key] > 0) == (key in expected), (key, counts)
    if "prims_dropped" in expected:
        assert counts["pairs_wanted"] > counts["pair_budget"]
    hold_kernel_route(got, scene, rays, 0.05, drops=drops, **kw)
