"""Part of tests/test_torch_layers.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import numpy as np
import pytest
import torch

from goliath_torch.nn import layers as tl
from goliath_tpu.nn import layers as jl

from tests.test_torch_layers import ATOL, RTOL, _run_both

torch.set_num_threads(1)


@pytest.mark.parametrize("cin,cout,size", [(16, 8, 8), (8, 5, 4)])
def test_conv_transpose2d_wnub_matches_jax(cin, cout, size):
    """The (in, out, kh, kw) weights carry over unchanged: JAX flips them
    into a dilated conv, F.conv_transpose2d takes them as stored."""
    x = np.random.RandomState(2).randn(2, cin, size, size).astype(np.float32)
    up = 2 * size
    got, ref = _run_both(
        jl.ConvTranspose2dWNUB(cin, cout, up, up, 4, 2, 1),
        tl.ConvTranspose2dWNUB(cin, cout, up, up, 4, 2, 1), x)
    assert got.shape == (2, cout, up, up)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_init_matches_the_reference_scheme():
    """The torch init follows the same recipe as the flax init: g equals
    ||v||_F, the uniform bound is sqrt(3) * glorot std, the transposed-conv
    quadrants are duplicated, biases start at zero. (The two frameworks
    draw different random numbers, so values are not compared.)"""
    g = torch.Generator().manual_seed(3)
    conv = tl.ConvTranspose2dWNUB(8, 6, 16, 16, 4, 2, 1, generator=g)
    v = conv.weight_v.detach()
    np.testing.assert_allclose(conv.weight_g.detach().numpy(),
                               np.full(6, float(v.norm())), rtol=1e-6)
    for q in (v[:, :, 0::2, 1::2], v[:, :, 1::2, 0::2], v[:, :, 1::2, 1::2]):
        assert torch.equal(q, v[:, :, 0::2, 0::2])
    std = tl.glorot_gain(0.2) * np.sqrt(2.0 / ((8 + 6) * 4))
    assert float(v.abs().max()) <= std * np.sqrt(3.0)
    assert float(conv.bias.detach().abs().max()) == 0.0
    again = tl.ConvTranspose2dWNUB(8, 6, 16, 16, 4, 2, 1,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.weight_v, conv.weight_v)  # seeded, repeatable
