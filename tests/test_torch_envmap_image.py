"""Part of tests/test_torch_envmap.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import envmap as te
from goliath_tpu.utils import envmap as je

from tests.test_torch_envmap import (
    SAMPLE_TOL,
    _camera,
    close,
    j_to_image,
    unit,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("blurbg", [False, True])
def test_envmap_to_image_matches_jax(blurbg):
    rng = np.random.default_rng(10)
    B, w, h = 2, 40, 28
    env = rng.random((B, 3, 16, 32)).astype(np.float32)
    K, R = _camera(rng, B, w, h)
    for camrot in (R, None):
        got = te.envmap_to_image(
            w, h, torch.from_numpy(env), torch.from_numpy(K[:, :2, 2]),
            torch.from_numpy(K),
            None if camrot is None else torch.from_numpy(camrot),
            blurbg=blurbg)
        ref = j_to_image(
            w, h, jnp.asarray(env), jnp.asarray(K[:, :2, 2]), jnp.asarray(K),
            None if camrot is None else jnp.asarray(camrot), blurbg=blurbg)
        close(got, ref, SAMPLE_TOL, SAMPLE_TOL)


@pytest.mark.parametrize("sigma", [0.2, 0.6])
def test_importance_sample_sg_matches_jax(sigma):
    rng = np.random.default_rng(12)
    Xi = rng.random((2, 2, 6, 9)).astype(np.float32)
    n = unit(rng, (2, 3, 6, 9), 1)
    n[0, :, 0, 0] = [0.0, 0.0, 1.0]      # the up-vector switch at z >= 0.999
    n[0, :, 0, 1] = [0.0, 0.0445, 0.999]
    got = te.importance_sample_sg(torch.from_numpy(Xi), torch.from_numpy(n),
                                  sigma)
    ref = je.importance_sample_sg(jnp.asarray(Xi), jnp.asarray(n), sigma)
    for g, r in zip(got, ref):
        close(g, r, SAMPLE_TOL, SAMPLE_TOL)
