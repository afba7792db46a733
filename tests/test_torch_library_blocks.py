"""The blocks' ``tile1d``, ``PixelShuffleWN`` (with its ICNR init) and
``UpscaleNet`` (nn/blocks.py) against the JAX package on the CPU, with
tests/test_torch_library.py's weight carry, gradients and tolerance (the
UNets: tests/test_torch_library_unet.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.nn import blocks as tb
from goliath_torch.models import mesh_vae as tmv
from goliath_tpu.nn import blocks as jb
from tests.test_torch_library import _gen, _x, hold

torch.set_num_threads(1)

CASES = {
    "pixel_shuffle_wn": (lambda: jb.PixelShuffleWN(4, 3, 2),
                         lambda: tb.PixelShuffleWN(4, 3, 2, generator=_gen()),
                         (2, 4, 5, 6)),
    "pixel_shuffle_wn_r3": (lambda: jb.PixelShuffleWN(2, 2, 3),
                            lambda: tb.PixelShuffleWN(2, 2, 3,
                                                      generator=_gen()),
                            (1, 2, 4, 4)),
    "upscale_net": (lambda: jb.UpscaleNet(3, 3, n_ftrs=4, size=16),
                    lambda: tb.UpscaleNet(3, 3, n_ftrs=4, size=16,
                                          generator=_gen()),
                    (2, 3, 16, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    hold_with_biases(*CASES[name])


def hold_with_biases(make_j, make_t, shape):
    tmod = make_t()
    with torch.no_grad():   # untied and tied biases start at 0: move them
        for pname, p in tmod.named_parameters():
            if pname.endswith("bias"):
                p.copy_(torch.from_numpy(0.1 * _x(tuple(p.shape), 5)))
    hold(make_j(), tmod, [_x(shape, 1)])


def test_tile1d_and_icnr_init():
    x = _x((2, 5), 2)
    got = tb.tile1d(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jb.tile1d(jnp.asarray(x), 7)))
    m = tb.PixelShuffleWN(16, 3, 2, generator=_gen())
    v = m.weight_v.detach().numpy()
    assert v.shape == (12, 16, 1, 1)
    for i in range(3):   # each sub-kernel repeated r^2 = 4 times in a row
        for j in range(1, 4):
            np.testing.assert_array_equal(v[4 * i + j], v[4 * i])
    assert np.abs(v).max() <= math.sqrt(6.0 / 16)
    np.testing.assert_allclose(m.weight_g.detach().numpy(),
                               np.linalg.norm(v), rtol=1e-6)
    # the blocks' UpscaleNet is not mesh_vae's own
    assert tb.UpscaleNet is not tmv.UpscaleNet
