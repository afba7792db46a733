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

from goliath_torch.ops import binning as tb
from goliath_torch.ops import mvp as tm
from goliath_torch.utils.sampling import grid_sample_3d
from goliath_tpu.ops import binning as jb
from goliath_tpu.ops import mvp as jm
from goliath_tpu.utils.sampling import grid_sample_3d as j_grid_sample_3d

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


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_3d_matches_jax(padding_mode, align_corners):
    """[C, D, H, W] volumes at coordinates reaching 0.4 outside [-1, 1]."""
    rng = np.random.RandomState(11)
    vol = rng.randn(3, 5, 6, 7).astype(np.float32)
    coords = ((rng.rand(4, 10, 3) - 0.5) * 2.8).astype(np.float32)
    ref = j_grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords),
                           padding_mode, align_corners)
    got = grid_sample_3d(T(vol), T(coords), padding_mode, align_corners)
    assert got.shape == (3, 4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


_CELL_CASES = {
    # spans to 6 cells an axis against kspan 3 (max_cells_per_prim 27)
    "cropped": dict(max_span=6, max_cells=27, invalid=0.0, budget=960),
    "invalid": dict(max_span=3, max_cells=64, invalid=0.3, budget=960),
    # 60 slots against ~130 wanted pairs
    "budget": dict(max_span=4, max_cells=64, invalid=0.1, budget=60),
}


@pytest.mark.parametrize("case", sorted(_CELL_CASES))
def test_bin_boxes_to_cells_matches_jax(case):
    c = _CELL_CASES[case]
    rng = np.random.RandomState(5)
    N, ncells = 120, (6, 5, 4)
    lo = np.stack([rng.randint(-2, n + 1, N) for n in ncells],
                  -1).astype(np.int32)
    hi = lo + rng.randint(0, c["max_span"] + 1, (N, 3)).astype(np.int32)
    valid = rng.rand(N) >= c["invalid"]
    budget = c["budget"]
    ref = jb.bin_boxes_to_cells(jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(valid), ncells, c["max_cells"],
                                budget)
    got = tb.bin_boxes_to_cells(T(lo), T(hi), T(valid), ncells,
                                c["max_cells"], budget)
    for name in ("sorted_prim", "cell_start", "cell_end"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    _, span = tb.cell_spans(T(lo), T(hi), ncells, c["max_cells"])
    wanted = int((span.prod(1) * T(valid)).sum())
    binned = int((got.cell_end - got.cell_start).sum())
    if case == "cropped":
        assert int((span == 3).sum()) > 0 and int(
            ((T(hi) - T(lo)).clamp(min=0) > 3).sum()) > 0
    if case == "budget":
        assert wanted > budget == binned
    else:
        assert wanted == binned


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


@pytest.mark.parametrize("case", sorted(_GRID_CASES))
def test_splat_density_grid_matches_jax(case):
    c = _GRID_CASES[case]
    primpos, primrot, primscale, alpha = _scene(c["seed"], c["K"],
                                                spread=c["spread"])
    kw = dict(grid_res=c["G"], block=c["block"],
              max_prims_per_block=c["mppb"], chunk=c["chunk"])
    ref = np.asarray(jm.splat_density_grid(
        jnp.asarray(primpos), jnp.asarray(primrot), jnp.asarray(primscale),
        jnp.asarray(alpha), **kw))
    drops = {}
    got = tm.splat_density_grid(T(primpos), T(primrot), T(primscale),
                                T(alpha), drops=drops, **kw)
    assert got.shape == (c["G"],) * 3 and float(ref.max()) > 1.0
    close(got.numpy(), ref)
    expected = _jax_drops(primpos, primrot, primscale, c["G"], c["block"],
                          c["mppb"], c["chunk"])
    assert {k: int(drops[k]) for k in expected} == expected
    assert int(drops["pairs_wanted"]) == expected["pairs_binned"]
    if case == "all_kept":
        assert expected["blocks_full"] == 0
        assert expected["prims_kept"] == c["K"]
    else:
        assert expected["blocks_full"] > 0 and expected["prims_dropped"] > 0


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


def test_shadow_at_points_exact_matches_jax(shadow_scene):
    """The per-prim oracle, 300 voxel centres at 24 steps."""
    (primpos, primrot, primscale, alpha), _, pts = shadow_scene
    pts = pts[::5][:300]
    lp = np.asarray(_LIGHTS["inside"], np.float32)
    ref = np.asarray(jm.shadow_at_points_exact(
        jnp.asarray(primpos), jnp.asarray(primrot), jnp.asarray(primscale),
        jnp.asarray(alpha), jnp.asarray(pts), jnp.asarray(lp), 24,
        point_chunk=128))
    got = tm.shadow_at_points_exact(T(primpos), T(primrot), T(primscale),
                                    T(alpha), T(pts), T(lp), 24)
    assert 0.05 < float(ref.mean()) < 0.95
    close(got.numpy(), ref, scale=1.0)


def test_shadow_volume_blocks_light():
    """tests/test_hand_teacher.py's occlusion check on the port alone: one
    opaque box at the origin; a point behind it (from the light) is
    shadowed, a point beside it is not."""
    density = tm.splat_density_grid(
        torch.zeros(1, 3), torch.eye(3)[None], torch.full((1, 3), 4.0),
        torch.full((1, 4, 4, 4), 40.0), 32)
    light = torch.tensor([0.0, 0.0, -0.9])
    pts = torch.tensor([[0.0, 0.0, 0.5], [0.8, 0.0, 0.5]])
    s = tm.shadow_at_points(density, pts, light, n_steps=48)
    assert s[0] > 0.9, f"occluded point not shadowed: {s}"
    assert s[1] < 0.1, f"unoccluded point shadowed: {s}"
