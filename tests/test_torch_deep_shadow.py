"""Parity of the port's deep shadows (goliath_torch/ops/mvp.py
``splat_density_grid``, ``shadow_at_points``, ``shadow_at_points_exact``,
ops/binning.py ``bin_boxes_to_cells`` and utils/sampling.py
``grid_sample_3d``) with the JAX package on the CPU, the same numpy-seeded
inputs through both: random boxes of tests/test_deep_shadow.py's kind (K 24
to 160 prims of 4^3 voxels in [-0.5, 0.5]^3).

The density grids are compared on the same geometry in both packages: a
prim box edge within an ulp of a block border bins to another block when
its inputs differ by an ulp, which moves the density by a whole prim's
alpha.

Tolerances: ``grid_sample_3d`` rtol 1e-6 (the same operations in the same
order); the binning and the drop counts exact (integer work); the density
grid rtol 1e-5 plus 1e-6 of its largest value (sums over a block's prims and
3-term contractions taken in other orders); the shadows rtol 1e-5 plus
1e-6 of 1, their largest possible value (32-64 midpoint samples summed in
other orders, XLA's fused multiply-adds in the JAX map's body).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import mvp as tm
from goliath_tpu.ops import binning as jb
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import _rotations

torch.set_num_threads(1)

RTOL, OF_SCALE = 1e-5, 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, of_scale=OF_SCALE, scale=None, err_msg=""):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL,
                               atol=of_scale * scale, err_msg=err_msg)


def _scene(seed, K=24, TD=4, spread=1.0):
    """Random prims as tests/test_deep_shadow.py's, alpha up to 8."""
    rng = np.random.RandomState(seed)
    primpos = ((rng.rand(K, 3) - 0.5) * spread).astype(np.float32)
    primrot = _rotations(rng, K)
    primscale = (3.0 + 3.0 * rng.rand(K, 3)).astype(np.float32)
    alpha = (rng.rand(K, TD, TD, TD) * 8.0).astype(np.float32)
    return primpos, primrot, primscale, alpha


def _voxel_centres(primpos, primrot, primscale, TD=4):
    ax = ((np.arange(TD, dtype=np.float32) + 0.5) / TD * 2 - 1)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    y = np.stack([xx, yy, zz], -1).reshape(-1, 3)
    world = primpos[:, None] + np.einsum("kij,vj->kvi", primrot, y) \
        / primscale[:, None]
    return world.reshape(-1, 3).astype(np.float32)


_CELL_CASES = {
    # spans to 6 cells an axis against kspan 3 (max_cells_per_prim 27)
    "cropped": dict(max_span=6, max_cells=27, invalid=0.0, budget=960),
    "invalid": dict(max_span=3, max_cells=64, invalid=0.3, budget=960),
    # 60 slots against ~130 wanted pairs
    "budget": dict(max_span=4, max_cells=64, invalid=0.1, budget=60),
}


def _jax_drops(primpos, primrot, primscale, G, block, max_prims_per_block,
               chunk, max_cells_per_prim=512, pair_budget_mult=128):
    """The density grid's drop counts from the JAX package's own binning
    (ops/mvp.py:745-752) in numpy."""
    pmin, pmax = jm.prim_world_aabb(jnp.asarray(primpos),
                                    jnp.asarray(primrot),
                                    jnp.asarray(primscale))
    to_cell = lambda p: (p + 1.0) * 0.5 * G / block
    bmin = jnp.floor(to_cell(pmin)).astype(jnp.int32)
    bmax = jnp.floor(to_cell(pmax)).astype(jnp.int32) + 1
    K = primpos.shape[0]
    NB = G // block
    cb = jb.bin_boxes_to_cells(bmin, bmax, jnp.ones((K,), bool),
                               (NB, NB, NB), max_cells_per_prim,
                               pair_budget_mult * K)
    start, end = np.asarray(cb.cell_start), np.asarray(cb.cell_end)
    prim = np.asarray(cb.sorted_prim)
    M = max(max_prims_per_block // chunk, 1) * chunk
    counts = end - start
    binned = set(prim[:counts.sum()].tolist())
    kept = set()
    for s, e in zip(start, end):
        kept.update(prim[s:min(e, s + M)].tolist())
    return {"pairs_binned": int(counts.sum()),
            "blocks_binned": int((counts > 0).sum()),
            "blocks_full": int((counts > M).sum()),
            "pairs_past_block": int(np.maximum(counts - M, 0).sum()),
            "max_block_list": int(counts.max()),
            "prims_binned": len(binned),
            "prims_kept": len(kept),
            "prims_dropped": len(binned - kept)}


_GRID_CASES = {
    # no block passes its 64 pairs
    "all_kept": dict(seed=0, K=24, spread=1.0, G=32, block=8, mppb=64,
                     chunk=16),
    # 160 prims in the centre blocks, 8 pairs evaluated a block
    "blocks_full": dict(seed=1, K=160, spread=0.6, G=16, block=4, mppb=8,
                        chunk=4),
}


@pytest.fixture(scope="module")
def shadow_scene():
    """The JAX density grid of a 24-prim scene (G 64, the teacher's) and
    the prims' voxel centres, fed to both packages."""
    primpos, primrot, primscale, alpha = _scene(2)
    density = np.asarray(jm.splat_density_grid(
        jnp.asarray(primpos), jnp.asarray(primrot), jnp.asarray(primscale),
        jnp.asarray(alpha), 64))
    pts = _voxel_centres(primpos, primrot, primscale)
    return (primpos, primrot, primscale, alpha), density, pts


_LIGHTS = {"inside": [0.0, 0.0, -0.9], "outside": [0.3, -0.2, -2.5]}


@pytest.mark.parametrize("light", sorted(_LIGHTS))
@pytest.mark.parametrize("chunked", [False, True])
def test_shadow_at_points_matches_jax(shadow_scene, light, chunked):
    """1,536 voxel centres at 32 steps, whole or in chunks of 500 points
    (the port) and 512 (the JAX package): the chunk size is a memory
    bound, not part of the result."""
    _, density, pts = shadow_scene
    lp = np.asarray(_LIGHTS[light], np.float32)
    ref = np.asarray(jm.shadow_at_points(
        jnp.asarray(density), jnp.asarray(pts), jnp.asarray(lp), 32,
        point_chunk=512 if chunked else 1 << 17))
    got = tm.shadow_at_points(T(density), T(pts), T(lp), 32,
                              point_chunk=500 if chunked else None)
    assert got.shape == (pts.shape[0],)
    assert 0.05 < float(ref.mean()) < 0.95 and float(ref.max()) == 1.0
    close(got.numpy(), ref, scale=1.0)
