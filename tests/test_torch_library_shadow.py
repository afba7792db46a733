"""``ShadowUNet_PoseCond`` and ``DistMapShadowUNet`` (nn/shadow.py) against
the JAX package on the CPU, with tests/test_torch_library.py's weight carry,
gradients and tolerance: inputs off the grid's size (the resize into the
grid, align_corners=False, and the encoder's and decoder's resizes,
align_corners=True), the untied and tied last conv.
"""

import numpy as np
import pytest
import torch

from goliath_torch.nn import shadow as tsh
from goliath_tpu.nn import shadow as jsh
from tests.test_torch_library import _gen, _x, hold

torch.set_num_threads(1)


def test_pose_cond_matches_jax():
    ao_mean = np.random.RandomState(3).rand(1, 48, 48).astype(np.float32)
    kw = dict(uv_size=64, ao_mean=ao_mean, shadow_size=32, n_dims=8,
              n_pose_dims=6, n_pose_enc_dims=4)
    ao = np.random.RandomState(1).rand(2, 1, 48, 48).astype(np.float32)
    got = hold(jsh.ShadowUNet_PoseCond(**kw),
               tsh.ShadowUNet_PoseCond(**kw, generator=_gen()),
               [ao, _x((2, 6), 2)])
    assert set(got) == {"shadow_map", "ao_map"}
    assert got["shadow_map"].shape == (2, 1, 64, 64)
    assert got["ao_map"].shape == (2, 1, 48, 48)


@pytest.mark.parametrize("biases", [True, False])
def test_dist_map_matches_jax(biases):
    kw = dict(uv_size=48, shadow_size=16, n_dist_joints=5, n_dims=8,
              biases=biases)
    got = hold(jsh.DistMapShadowUNet(**kw),
               tsh.DistMapShadowUNet(**kw, generator=_gen()),
               [_x((2, 5, 24, 24), 4)])
    assert set(got) == {"shadow_map", "shadow_map_lowres"}
    assert got["shadow_map_lowres"].shape == (2, 1, 16, 16)
    last = tsh.DistMapShadowUNet(**kw).shadow_pred.bias
    assert last.shape == ((1, 16, 16) if biases else (1,))
