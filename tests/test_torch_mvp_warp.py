"""Part of tests/test_torch_mvp.py's tests, in a file of their own: a port test
file that runs long holds at most four tests, so that pytest-xdist's --dist
loadfile queues it after tests/test_tile_shard.py. The inputs, helpers and
tolerances are that file's. The case also holds K8's plain version with
the warp field (tests/test_torch_mvp_kernel.py ``hold_kernel_route``).
"""

import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.ops import mvp as tm
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import (
    MARCH_OF_SCALE,
    T,
    _rays,
    _scene,
    _tiled,
    close,
)
from tests.test_torch_mvp_kernel import hold_kernel_route

torch.set_num_threads(1)


def test_tiled_march_with_warp_matches_jax():
    scene = _scene(1, K=8)
    K, TD = 8, 4
    ax = np.linspace(-1, 1, TD, dtype=np.float32)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    warp = (np.stack([xx, yy, zz], 0)[None].repeat(K, 0) + 0.15
            * np.random.RandomState(2).randn(K, 3, TD, TD, TD)
            .astype(np.float32))
    rays = _rays(16, 16)
    kw = dict(max_steps=60, max_prims_per_tile=8, chunk=4)
    ref = _tiled(jm, scene, rays, 0.1, warp=jnp.asarray(warp), **kw)
    got = _tiled(tm, scene, rays, 0.1, warp=T(warp), **kw)
    assert ref[3].max() > 0.3
    close(got, ref, MARCH_OF_SCALE)
    hold_kernel_route(got, scene, rays, 0.1, warp=warp, **kw)
