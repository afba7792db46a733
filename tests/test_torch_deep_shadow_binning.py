"""Part of tests/test_torch_deep_shadow.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import binning as tb
from goliath_tpu.ops import binning as jb

from tests.test_torch_deep_shadow import T, _CELL_CASES

torch.set_num_threads(1)


@pytest.mark.parametrize("case", sorted(_CELL_CASES))
def test_bin_boxes_to_cells_matches_jax(case):
    c = _CELL_CASES[case]
    rng = np.random.RandomState(5)
    N, ncells = 120, (6, 5, 4)
    lo = np.stack([rng.randint(-2, n + 1, N) for n in ncells],
                  -1).astype(np.int32)
    hi = lo + rng.randint(0, c["max_span"] + 1, (N, 3)).astype(np.int32)
    valid = rng.rand(N) >= c["invalid"]
    budget = c["budget"]
    ref = jb.bin_boxes_to_cells(jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(valid), ncells, c["max_cells"],
                                budget)
    got = tb.bin_boxes_to_cells(T(lo), T(hi), T(valid), ncells,
                                c["max_cells"], budget)
    for name in ("sorted_prim", "cell_start", "cell_end"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    _, span = tb.cell_spans(T(lo), T(hi), ncells, c["max_cells"])
    wanted = int((span.prod(1) * T(valid)).sum())
    binned = int((got.cell_end - got.cell_start).sum())
    if case == "cropped":
        assert int((span == 3).sum()) > 0 and int(
            ((T(hi) - T(lo)).clamp(min=0) > 3).sum()) > 0
    if case == "budget":
        assert wanted > budget == binned
    else:
        assert wanted == binned
