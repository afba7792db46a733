"""Parity of the port's band-split render (goliath_torch.parallel.tile_shard
``render_tile_sharded``, and ``prepare_sample``'s band binning) with the JAX
package on the CPU.

The JAX side runs on a mesh of as many virtual CPU devices as the port's
mesh has shards (all on ``cpu``), under ``jax.jit`` (one value_and_grad
compile a case: eagerly, the JAX render takes ~30 s here). The port's
compositor is K1's plain version (the XLA window without ``use_pallas``,
the Pallas window with it; the JAX side then runs its Pallas kernels in
interpret mode).

Tolerances: outputs atol 2e-5 and gradients 1e-4 of their largest entry,
as tests/test_tile_shard.py holds the JAX band render against the JAX
single render (float32 sums in other orders; the port's compositor is
held to the JAX one at 1e-4 in tests/test_torch_gsplat.py, and these
scenes are far from opaque). The band binning is equal bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat as tg
from goliath_torch.parallel.sharding import Mesh
from goliath_torch.parallel.tile_shard import (
    band_geometry,
    render_tile_sharded,
)
from goliath_tpu.ops import gsplat as jg, gsplat_pallas
from goliath_tpu.parallel.sharding import make_mesh as jax_make_mesh
from goliath_tpu.parallel.tile_shard import (
    render_tile_sharded as jax_render_tile_sharded,
)

torch.set_num_threads(1)

B, N, H, W = 2, 96, 64, 32
KW = dict(tile_size=16, max_pairs_per_tile=256, chunk=32, pair_budget_mult=8)
BINNING = ("sorted_prim", "tile_start", "tile_end", "perm", "prim_offsets",
           "prim_ends", "tile_of_pair")


@functools.lru_cache(maxsize=None)
def scene():
    """tests/test_tile_shard.py's scene at N = 96: well-separated depths,
    random rotations, small scales."""
    rs = np.random.RandomState(11)
    K = np.asarray([[[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]] * B,
                   np.float32)
    Rt = np.asarray([np.eye(4)[:3]] * B, np.float32)
    pos = rs.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    pos[..., 2] = rs.uniform(3.0, 9.0, (B, N))
    quat = rs.standard_normal((B, N, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    scale = np.exp(rs.standard_normal((B, N, 3)) * 0.3).astype(
        np.float32) * 0.05
    op = rs.uniform(0.2, 0.9, (B, N, 1)).astype(np.float32)
    col = rs.uniform(0, 1, (B, N, 3)).astype(np.float32)
    return K, Rt, pos, quat, scale, op, col


def _target():
    return np.full((B, 3, H, W), 0.4, np.float32)


def test_prepare_sample_band_binning_matches_jax():
    """One band (rows 32-63 of the 64-row image, y_offset 32, bin height
    32): the same projection and the same binning arrays, bit for bit, on
    the band's 2 x 2 tile grid; the depth bits follow the band's tiles."""
    K, Rt, pos, quat, scale, op, col = scene()
    args = (K[1], Rt[1], pos[1], quat[1], scale[1], op[1], col[1])
    kw = dict(pair_budget=400, y_offset_px=32.0, bin_img_h=32)
    ref = jg.prepare_sample(*map(jnp.asarray, args), H, W, 16, **kw)
    got = tg.prepare_sample(*map(torch.from_numpy, args), H, W, 16, **kw)
    for name, g, r in zip(("xys", "conics", "op_s", "chan"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    gb, rb = got[6], ref[6]
    assert (gb.num_tiles_x, gb.num_tiles_y) == (2, 2)
    for name in BINNING:
        np.testing.assert_array_equal(getattr(gb, name).numpy(),
                                      np.asarray(getattr(rb, name)),
                                      err_msg=name)
    # the band holds pairs, and the full image's binning other ones
    assert int(gb.tile_end[-1]) > 0
    full = tg.prepare_sample(*map(torch.from_numpy, args), H, W, 16,
                             pair_budget=400)[6]
    assert full.num_tiles_y == 4
    assert int(full.tile_end[-1]) > int(gb.tile_end[-1])


@functools.lru_cache(maxsize=None)
def jax_band_render(nbands, use_pallas):
    """Value, outputs and gradients (pos, scale, op, col) of the JAX band
    render on a mesh of ``nbands`` CPU devices, jitted."""
    K, Rt, pos, quat, scale, op, col = map(jnp.asarray, scene())
    mesh = jax_make_mesh(nbands, axis_name="tile")
    tgt = jnp.asarray(_target())

    def loss(pos, scale, op, col):
        r = jax_render_tile_sharded(
            mesh, "tile", W, H, K, Rt, pos, quat, scale, op, col,
            use_pallas=use_pallas, pallas_inner=16, **KW)
        return ((r["render"] - tgt) ** 2).mean() + r["alpha"].mean(), r

    interp = gsplat_pallas.INTERPRET
    gsplat_pallas.INTERPRET = True
    try:
        (v, r), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(pos, scale, op, col)
        return (float(v), {k: np.asarray(x) for k, x in r.items()},
                [np.asarray(x) for x in g])
    finally:
        gsplat_pallas.INTERPRET = interp


@pytest.mark.parametrize("nbands, use_pallas", [
    (2, False),
    (4, False),
    # 3 does not divide the 4 tile rows: 3 bands of 2 rows, cropped
    (3, True),
])
def test_render_tile_sharded_matches_jax(nbands, use_pallas):
    """Outputs, the loss and its gradients of the band render on a mesh of
    ``nbands`` shards (all on the CPU) against the JAX band render."""
    ref_v, ref_r, ref_g = jax_band_render(nbands, use_pallas)
    K, Rt, pos, quat, scale, op, col = map(torch.from_numpy, scene())
    leaves = [x.clone().requires_grad_(True) for x in (pos, scale, op, col)]
    mesh = Mesh(["cpu"] * nbands, ("tile",))
    r = render_tile_sharded(mesh, "tile", W, H, K, Rt, leaves[0], quat,
                            leaves[1], leaves[2], leaves[3],
                            use_pallas=use_pallas, pallas_inner=16, **KW)
    v = ((r["render"] - torch.from_numpy(_target())) ** 2).mean() \
        + r["alpha"].mean()
    v.backward()
    assert set(r) == set(ref_r)
    for key in ref_r:
        assert tuple(r[key].shape) == ref_r[key].shape, key
        np.testing.assert_allclose(r[key].detach().numpy(), ref_r[key],
                                   atol=2e-5, err_msg=key)
    # rtol 2e-4 as tests/test_tile_shard.py: XLA's float32 mean over the
    # image is ~2e-5 from a float64 one here, the port's ~1e-7
    np.testing.assert_allclose(v.item(), ref_v, rtol=2e-4)
    for leaf, ref, name in zip(leaves, ref_g, ("pos", "scale", "op", "col")):
        s = np.abs(ref).max() + 1e-8
        assert s > 1e-6, name
        np.testing.assert_allclose(leaf.grad.numpy() / s, ref / s,
                                   atol=1e-4, err_msg=name)
    ntx, band_nty, band_h, budget = band_geometry(
        W, H, 16, nbands, N, KW["pair_budget_mult"], 64)
    assert (ntx, band_nty * nbands >= 4, band_h * nbands >= H) == (
        2, True, True)
    assert budget == max(round(8 * N / nbands), 8 * 64)
    assert float(r["alpha"].detach().max()) > 0.5
