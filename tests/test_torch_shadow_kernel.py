"""K9's plain version (goliath_torch/ops/mvp_cuda.py ``shadow_integral``,
which runs ``shadow_integral_plain`` on CPU tensors: every point at once)
against the JAX package's ``shadow_at_points`` on a seeded 16^3 density
grid, with lights inside and outside the [-1, 1] volume, points that share
one or two of the light's coordinates (direction components of exactly 0,
and a point 1e-13 off the light's zero coordinate: a component below 1e-12
whose sign is dropped), points on the volume's faces and corners, and a point at the
light (a segment of length 0).

Tolerance: rtol 1e-5 plus 1e-6 of the largest |value| (32 midpoint
samples summed in other orders; XLA's fused multiply-adds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp_cuda as mc
from goliath_tpu.ops import mvp as jm

torch.set_num_threads(1)

RTOL, OF_SCALE = 1e-5, 1e-6
G, N_STEPS = 16, 32

# each light has a coordinate of 0: a point 1e-13 off it gives a direction
# component below 1e-12 that is not 0
LIGHTS = {"inside": [0.0, -0.2, 0.3], "outside": [0.3, 0.0, -2.5],
          "outside_far": [-3.0, 1.5, 0.0]}


def _points(light, seed=0):
    rng = np.random.RandomState(seed)
    lp = np.asarray(light, np.float32)
    pts = [(rng.rand(600, 3) - 0.5) * 2.4]                 # in and around
    face = (rng.rand(60, 3) - 0.5) * 2.0
    face[np.arange(60), np.arange(60) % 3] = np.where(np.arange(60) % 2,
                                                      1.0, -1.0)
    pts.append(face)                                       # on the faces
    pts.append(np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                         for z in (-1, 1)], np.float64))   # the corners
    axis = np.repeat(lp[None], 40, 0).astype(np.float64)
    axis[:20, 0] = np.linspace(-1, 1, 20)                  # y, z shared
    axis[20:, 1] = np.linspace(-1, 1, 20)
    axis[30:, 2] = np.linspace(-0.9, 0.9, 10)              # z differs too
    pts.append(axis)
    k = int(np.flatnonzero(lp == 0)[0])
    off = lp.astype(np.float64)
    off[k] = -1e-13                                        # |dirn_k| < 1e-12
    off[(k + 1) % 3] -= 0.8
    pts += [off[None], lp[None].astype(np.float64)]        # a point at the light
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_shadow_integral_matches_jax(light):
    rng = np.random.RandomState(1)
    density = (rng.rand(G, G, G) * 1.5).astype(np.float32)
    density[rng.rand(G, G, G) < 0.3] = 0.0
    lp = np.asarray(LIGHTS[light], np.float32)
    pts = _points(lp)
    ref = np.asarray(jax.jit(jm.shadow_at_points, static_argnums=3)(
        jnp.asarray(density), jnp.asarray(pts), jnp.asarray(lp), N_STEPS))
    got = mc.shadow_integral(torch.from_numpy(density),
                             torch.from_numpy(pts), torch.from_numpy(lp),
                             N_STEPS).numpy()
    assert got.shape == ref.shape == (pts.shape[0],)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=OF_SCALE * float(np.abs(ref).max()))
    assert got[-1] == 0.0                      # the point at the light
    assert 0.05 < float(ref.mean()) < 0.95 and float(ref.max()) == 1.0
