"""Part of tests/test_torch_body_utils.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import numpy as np
import pytest
import torch

from goliath_torch.nn import blocks as tb, layers as tl, unet as tu
from goliath_tpu.nn import blocks as jb, layers as jl, unet as ju

from tests.test_torch_body_utils import _close, _module_outputs

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", (["conv_wn", "conv_block", "conv_down",
                                  "up_conv_deep", "unet"])[0:4])
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
