"""``ConcatPyramid`` (both of tests/test_parity_extras.py's upsampling
branches, and one with a conv before every level) against the JAX package
on the CPU, with tests/test_torch_library.py's weight carry, gradients and
tolerance; and the inits of the new layers.
"""

import math

import numpy as np
import pytest
import torch

from goliath_torch.nn import layers as tl
from goliath_tpu.nn import layers as jl
from tests.test_torch_library import _gen, _x, hold

torch.set_num_threads(1)


def _pyramid_branch(lib, gen):
    kw = {} if lib is jl else {"generator": gen}
    return [lib.ConvTranspose2dWN(8 + 2, 8, 4, 2, 1, **kw),
            lib.LeakyReLU(0.2),
            lib.ConvTranspose2dWN(8 + 2, 8, 4, 2, 1, **kw),
            lib.LeakyReLU(0.2)]


# tests/test_parity_extras.py's shapes: the upsampling branch on y at the
# last layer's input size, and transposed (one blur-decimation down)
PYRAMID_CASES = {
    "upsampling": dict(transposed=False, x=(1, 8, 8, 8), y=(1, 2, 16, 16),
                       out=(1, 8, 32, 32)),
    "transposed": dict(transposed=True, x=(1, 8, 4, 4), y=(1, 2, 16, 16),
                       out=(1, 8, 16, 16)),
    "every_layer": dict(transposed=False, x=(2, 8, 4, 4), y=(2, 2, 8, 8),
                        out=(2, 8, 16, 16), every_other=False),
}


@pytest.mark.parametrize("name", sorted(PYRAMID_CASES))
def test_concat_pyramid_matches_jax(name):
    case = PYRAMID_CASES[name]
    every_other = case.get("every_other", True)
    if every_other:
        jb = _pyramid_branch(jl, None)
        tb = _pyramid_branch(tl, _gen())
    else:   # a conv before every pyramid level, no activation between
        jb = [jl.ConvTranspose2dWN(8 + 2, 8, 4, 2, 1),
              jl.ConvTranspose2dWN(8 + 2, 8, 4, 2, 1)]
        tb = [tl.ConvTranspose2dWN(8 + 2, 8, 4, 2, 1, generator=_gen()),
              tl.ConvTranspose2dWN(8 + 2, 8, 4, 2, 1, generator=_gen())]
    jmod = jl.ConcatPyramid(branch=jb, n_concat_in=2, every_other=every_other,
                            transposed=case["transposed"])
    tmod = tl.ConcatPyramid(tb, n_concat_in=2, every_other=every_other,
                            transposed=case["transposed"])
    got = hold(jmod, tmod, [_x(case["x"], 1), _x(case["y"], 2)])
    assert tuple(got.shape) == case["out"]


def test_layer_inits():
    """The tied-bias transposed conv's init (glorot std, 2x2 quadrants
    equal, g = ||v||), the ELR layers' N(0, 1/lr_mul) draws from the
    generator, LeakyReLU's equality and gaussian_kernel as the JAX
    package's."""
    m = tl.ConvTranspose2dWN(64, 32, 4, 2, 1, generator=_gen())
    v = m.weight_v.detach().numpy()
    np.testing.assert_array_equal(v[:, :, 0::2, 1::2], v[:, :, 0::2, 0::2])
    np.testing.assert_array_equal(v[:, :, 1::2, 1::2], v[:, :, 0::2, 0::2])
    std = tl.glorot_gain(0.2) * math.sqrt(2.0 / (96 * 4))
    assert abs(v[:, :, 0::2, 0::2].std() / std - 1) < 0.05
    np.testing.assert_allclose(m.weight_g.detach().numpy(),
                               np.linalg.norm(v), rtol=1e-6)
    assert m.bias.shape == (32,) and not m.bias.detach().any()
    w = tl.LinearELR(256, 128, lr_mul=0.25, generator=_gen()).weight
    assert abs(float(w.detach().std()) * 0.25 - 1) < 0.02
    assert torch.equal(
        tl.Conv2dELR(3, 4, 3, generator=_gen()).weight,
        torch.randn((4, 3, 3, 3), generator=_gen()))
    assert tl.LeakyReLU(0.2) == tl.LeakyReLU(0.2) != tl.LeakyReLU(0.1)
    assert len({tl.LeakyReLU(0.2), tl.LeakyReLU(0.2)}) == 1
    for ksize, std in ((7, None), (5, None), (3, 1.5)):
        np.testing.assert_array_equal(tl.gaussian_kernel(ksize, std),
                                      jl.gaussian_kernel(ksize, std))
