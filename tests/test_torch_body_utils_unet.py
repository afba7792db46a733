"""Part of tests/test_torch_body_utils.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.nn import (
    blocks as tb,
    layers as tl,
    shadow as tsh,
    unet as tu,
)
from goliath_torch.utils import image as timage
from goliath_tpu.nn import (
    blocks as jb,
    layers as jl,
    shadow as jsh,
    unet as ju,
)
from goliath_tpu.utils import image as jimage

from tests.test_torch_body_utils import _close, _module_outputs

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", (["conv_wn", "conv_block", "conv_down",
                                  "up_conv_deep", "unet"])[4:5])
def test_blocks_match_jax(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    mods = {
        "conv_wn": (jl.Conv2dWN(4, 6, 3, 2, 1, groups=2),
                    tl.Conv2dWN(4, 6, 3, 2, 1, groups=2)),
        "conv_block": (jb.ConvBlock(4, 6, 16), tb.ConvBlock(4, 6, 16)),
        "conv_down": (jb.ConvDownBlock(4, 6, 16, groups=2),
                      tb.ConvDownBlock(4, 6, 16, groups=2)),
        "up_conv_deep": (jb.UpConvBlockDeep(4, 6, 32, groups=2),
                         tb.UpConvBlockDeep(4, 6, 32, groups=2)),
        "unet": (ju.UNetWB(4, 3, 64, n_init_ftrs=4),
                 tu.UNetWB(4, 3, 64, n_init_ftrs=4)),
    }
    if kind == "unet":
        x = rng.randn(1, 4, 64, 64).astype(np.float32)
    got, ref = _module_outputs(*mods[kind], x)
    _close(got, ref)


def test_pixel_shuffle_and_tile2d_match_jax():
    x = np.random.RandomState(1).randn(2, 12, 3, 5).astype(np.float32)
    _close(tb.pixel_shuffle(torch.from_numpy(x), 2),
           jb.pixel_shuffle(jnp.asarray(x), 2), atol=0, rtol=0)
    p = x[:, :, 0, 0]
    _close(tb.tile2d(torch.from_numpy(p), 4), jb.tile2d(jnp.asarray(p), 4),
           atol=0, rtol=0)


def test_pose_to_shadow_matches_jax():
    pose = np.random.RandomState(3).randn(1, 5).astype(np.float32)
    got, ref = _module_outputs(jsh.PoseToShadow(n_pose_dims=5, uv_size=96),
                               tsh.PoseToShadow(n_pose_dims=5, uv_size=96),
                               pose)
    _close(got["shadow_map"], ref["shadow_map"])


def test_gaussian_blur_np_matches_jax():
    x = np.random.RandomState(5).rand(1, 3, 40, 40).astype(np.float32)
    np.testing.assert_array_equal(timage.gaussian_blur_np(x, 11),
                                  jimage.gaussian_blur_np(x, 11))
