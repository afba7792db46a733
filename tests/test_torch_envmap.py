"""Parity of the port's envmap utilities (utils/hdr.py, utils/envmap.py,
utils/mipmap_sampler.py, utils/sampling.avg_pool2d) and of
SingleLightCycleDecorator with the JAX package on the CPU, on the same
numpy inputs made from a seed.

Tolerances: the file readers and ``resize_area`` are numpy in both
packages and held bit for bit (and the .hdr decode against an independent
decode of the bytes). ``dir2uv`` rtol 1e-6 (atan2 and acos of float32,
each within an ulp or two of the other's) plus two ulps of 1 (the
v = 2 acos / pi - 1 of an equator direction cancels to near 0). The samplers (``grid_sample``
at coordinates that went through sin, cos, atan2 and acos) rtol 1e-5 plus
1e-5 of the largest value; the blurred background the same (a 101x101 sum
in another order). ``importance_sample_sg``: torch.erfinv against XLA's
float32 erfinv polynomial differ by a few ulp, and its slope grows
without bound as the argument nears 1; directions and pdf at rtol 1e-5
plus 1e-5 of the largest value. ``avg_pool2d`` and ``mipmap_grid_sample``
rtol 1e-6 plus 1e-6 (sums of the same terms, lerps of the same samples).
The point-light sweep's lights are numpy in both packages: bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.utils import envmap as te
from goliath_tpu.utils import envmap as je
from goliath_tpu.utils.quaternion import axisangle_to_matrix as j_aa

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

SAMPLE_TOL = 1e-5
EXACT_TOL = 1e-6
CPU = types.SimpleNamespace(device=torch.device("cpu"))

# the JAX references jitted: eagerly JAX compiles and dispatches each of
# their gathers one by one
j_rotate = jax.jit(je.rotate_envmap_mat)
j_to_image = jax.jit(je.envmap_to_image, static_argnums=(0, 1),
                     static_argnames=("blurbg",))
j_mirrorball = jax.jit(je.envmap_to_mirrorball, static_argnums=(0, 1))
j_prefilter = jax.jit(je.prefilter_envmap_sg, static_argnums=(0, 4))
j_compose = jax.jit(je.compose_envmap)


def close(got, ref, rtol, of_max):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=of_max * float(np.abs(ref).max()))


def unit(rng, shape, axis):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def rotation(rng):
    r = rng.standard_normal(3).astype(np.float32)
    return np.array(j_aa(jnp.asarray(r)))


# --- utils/hdr.py ---------------------------------------------------------

def _hdr_header(H, W):
    return (b"#?RADIANCE\n# made by a test\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {H} +X {W}\n".encode())


def _decode(rgbe):
    """Independent RGBE decode: m * 2^(e - 136), 0 where e == 0."""
    m = rgbe[..., :3].astype(np.float64)
    e = rgbe[..., 3].astype(np.int64)
    return np.where(e[..., None] > 0, m * np.exp2(e - 136)[..., None], 0.0)


def _rle_channel(vals):
    """One channel plane of a scanline as alternating runs and literals."""
    out, x, W = bytearray(), 0, len(vals)
    while x < W:
        run = 1
        while x + run < W and vals[x + run] == vals[x] and run < 127:
            run += 1
        if run >= 3:
            out += bytes([128 + run, vals[x]])
            x += run
            continue
        n = 1
        while x + n < W and n < 128 and not (
                x + n + 2 < W and vals[x + n] == vals[x + n + 1]
                == vals[x + n + 2]):
            n += 1
        out += bytes([n]) + bytes(vals[x: x + n])
        x += n
    return bytes(out)


# --- utils/sampling.py, utils/envmap.py ------------------------------------


def test_rotate_envmap_mat_matches_jax():
    rng = np.random.default_rng(9)
    img = rng.random((3, 16, 32)).astype(np.float32)
    for rot in (rotation(rng), np.eye(3, dtype=np.float32)):
        close(te.rotate_envmap_mat(torch.from_numpy(img),
                                   torch.from_numpy(rot)),
              j_rotate(jnp.asarray(img), jnp.asarray(rot)),
              SAMPLE_TOL, SAMPLE_TOL)
    close(te.rotate_envmap(torch.from_numpy(img), 0.3, -1.1, 2.0),
          je.rotate_envmap(jnp.asarray(img), 0.3, -1.1, 2.0),
          SAMPLE_TOL, SAMPLE_TOL)


def _camera(rng, B, w, h):
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(30, 60, B)
    K[:, 1, 1] = K[:, 0, 0] * rng.uniform(0.9, 1.1, B)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2 + 1.5, h / 2 - 2.0, 1.0
    R = np.stack([rotation(rng) for _ in range(B)])
    return K, R


def test_envmap_to_mirrorball_matches_jax():
    rng = np.random.default_rng(11)
    env = rng.random((2, 3, 16, 32)).astype(np.float32)
    R = np.stack([rotation(rng) for _ in range(2)])
    for camrot in (R, None):
        got = te.envmap_to_mirrorball(
            24, 24, torch.from_numpy(env),
            None if camrot is None else torch.from_numpy(camrot))
        ref = j_mirrorball(
            24, 24, jnp.asarray(env),
            None if camrot is None else jnp.asarray(camrot))
        assert tuple(got.shape) == (2, 4, 24, 24)
        np.testing.assert_array_equal(got[:, 3].numpy(),
                                      np.asarray(ref[:, 3]))
        close(got, ref, SAMPLE_TOL, SAMPLE_TOL)


def _jax_draws(level, shape, n):
    key = jax.random.fold_in(jax.random.PRNGKey(7), level)
    return [np.array(jax.random.uniform(jax.random.fold_in(key, i), shape))
            for i in range(n)]


def test_prefilter_envmap_sg_matches_jax_on_its_draws():
    rng = np.random.default_rng(13)
    env = rng.random((1, 3, 8, 16)).astype(np.float32)
    v = unit(rng, (1, 3, 8, 16), 1)
    sigma, n = 0.4, 3
    ref = j_prefilter(
        sigma, jnp.asarray(v), jnp.asarray(env),
        jax.random.fold_in(jax.random.PRNGKey(7), 1), n)
    draws = [torch.from_numpy(d) for d in _jax_draws(1, (1, 2, 8, 16), n)]
    got = te.prefilter_envmap_sg(sigma, torch.from_numpy(v),
                                 torch.from_numpy(env), draws=draws)
    close(got, ref, SAMPLE_TOL, SAMPLE_TOL)
    # the generator route: the same function of its own draws
    g = torch.Generator().manual_seed(7)
    own = te.prefilter_envmap_sg(sigma, torch.from_numpy(v),
                                 torch.from_numpy(env), n, generator=g)
    g = torch.Generator().manual_seed(7)
    again = [torch.rand((1, 2, 8, 16), generator=g) for _ in range(n)]
    torch.testing.assert_close(
        own, te.prefilter_envmap_sg(sigma, torch.from_numpy(v),
                                    torch.from_numpy(env), draws=again),
        rtol=0, atol=0)


def test_compose_envmap_matches_jax():
    rng = np.random.default_rng(14)
    B, w, h = 1, 36, 30
    render = rng.random((B, 3, h, w)).astype(np.float32) * 0.5
    alpha = rng.random((B, 1, h, w)).astype(np.float32)
    env = rng.random((B, 3, 16, 32)).astype(np.float32) * 2.0
    K, R = _camera(rng, B, w, h)
    Rt = np.concatenate([R, rng.standard_normal((B, 3, 1)).astype(
        np.float32)], -1)
    args = (render, alpha, env, K, Rt)
    got = te.compose_envmap(*map(torch.from_numpy, args))
    ref = j_compose(*map(jnp.asarray, args))
    close(got, ref, SAMPLE_TOL, SAMPLE_TOL)


# --- utils/mipmap_sampler.py ------------------------------------------------


# --- utils/light_decorator.py: the point-light sweep ------------------------
