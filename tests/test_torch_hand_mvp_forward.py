"""Part of tests/test_torch_hand_mvp.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_hand_mvp import both
from tests.test_torch_mesh_vae import close_to_scale

torch.set_num_threads(1)


@pytest.mark.parametrize("key", ([
    "rgb", "alpha", "primpos", "primrot", "primscale", "primalpha",
    "primrgb", "mvp_window_overflow", "geom_lbs", "learn_blur_weights"])[4:8])
def test_hand_mvp_forward_matches_jax(both, key):
    got, ref = both
    assert set(got) == set(ref)
    g, r = got[key].numpy(), np.asarray(ref[key])
    assert g.shape == r.shape and np.isfinite(g).all()
    close_to_scale(g, r, err_msg=key)
    if key == "alpha":
        assert float(r.max()) > 0.05   # the hand is visible
