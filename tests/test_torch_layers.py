"""Parity of goliath_torch.nn.layers with the JAX package's weight-normalized
layers on the CPU, after goliath_torch.convert.params_from_jax.

Tolerance: atol 1e-5, rtol 1e-5. Both sides run the same float32 products
on the CPU; they differ only in summation order inside the convolution and
matmul routines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.nn import layers as tl
from goliath_tpu.nn import layers as jl

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _run_both(jmod, tmod, x):
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    tmod.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    return got, ref


def test_linear_wn_matches_jax():
    x = np.random.RandomState(0).randn(3, 17).astype(np.float32)
    got, ref = _run_both(jl.LinearWN(17, 9, alpha=1.0), tl.LinearWN(17, 9),
                         x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cin,cout,size", [(3, 8, 16), (8, 4, 8)])
def test_conv2d_wnub_matches_jax(cin, cout, size):
    x = np.random.RandomState(1).randn(2, cin, size, size).astype(np.float32)
    half = size // 2
    got, ref = _run_both(jl.Conv2dWNUB(cin, cout, half, half, 4, 2, 1),
                         tl.Conv2dWNUB(cin, cout, half, half, 4, 2, 1), x)
    assert got.shape == (2, cout, half, half)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


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


def test_weight_norm_is_over_the_whole_tensor():
    """w = v * g / ||v||_F with ONE norm over all of v, which is not what
    torch.nn.utils.weight_norm computes (one norm per output channel)."""
    layer = tl.LinearWN(6, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.weight_g.copy_(torch.arange(1.0, 5.0))
        w = layer.weight()
    v = layer.weight_v.detach()
    np.testing.assert_allclose(
        w.numpy(), (v * torch.arange(1.0, 5.0)[:, None] / v.norm()).numpy(),
        rtol=1e-6)
    per_row = v * torch.arange(1.0, 5.0)[:, None] / v.norm(dim=1,
                                                           keepdim=True)
    assert not np.allclose(w.numpy(), per_row.numpy())


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
