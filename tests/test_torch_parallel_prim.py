"""Parity of the port's depth-slab render (goliath_torch.parallel.tile_shard
``render_prim_sharded``) and of ``composite_over`` with the JAX package on
the CPU: the slabs of a stable argsort of the exact depths, the tail padded
with the farthest prim at opacity 0, each slab rendered over the full image
and folded front to back.

The JAX side runs on a mesh of as many virtual CPU devices as the port's
mesh has shards, under ``jax.jit``. Tolerances: outputs atol 5e-5 and
gradients 2e-4 of their largest entry, as tests/test_tile_shard.py holds
the JAX slab render against the JAX single render (each slab's
compositor sums in float32 in another order than one render would, and
the fold multiplies the slabs' transmittances). composite_over: rtol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.parallel.sharding import Mesh
from goliath_torch.parallel.tile_shard import (
    composite_over,
    render_prim_sharded,
)
from goliath_tpu.ops import gsplat_pallas
from goliath_tpu.parallel.sharding import make_mesh as jax_make_mesh
from goliath_tpu.parallel.tile_shard import (
    composite_over as jax_composite_over,
    render_prim_sharded as jax_render_prim_sharded,
)

torch.set_num_threads(1)

B, N, H, W = 2, 98, 64, 32     # N is not a multiple of the slab counts
KW = dict(tile_size=16, max_pairs_per_tile=256, chunk=32, pair_budget_mult=8)


@functools.lru_cache(maxsize=None)
def scene():
    rs = np.random.RandomState(12)
    K = np.asarray([[[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]] * B,
                   np.float32)
    Rt = np.asarray([np.eye(4)[:3]] * B, np.float32)
    Rt[1, :, 3] = (0.1, -0.2, 0.3)    # the depth's offset term
    pos = rs.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    pos[..., 2] = rs.uniform(3.0, 9.0, (B, N))
    quat = rs.standard_normal((B, N, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    scale = np.exp(rs.standard_normal((B, N, 3)) * 0.3).astype(
        np.float32) * 0.05
    op = rs.uniform(0.2, 0.9, (B, N, 1)).astype(np.float32)
    col = rs.uniform(0, 1, (B, N, 3)).astype(np.float32)
    bg = np.asarray([0.1, 0.5, 0.9], np.float32)
    return K, Rt, pos, quat, scale, op, col, bg


@functools.lru_cache(maxsize=None)
def jax_slab_render(nslabs, use_pallas):
    K, Rt, pos, quat, scale, op, col, bg = map(jnp.asarray, scene())
    mesh = jax_make_mesh(nslabs, axis_name="slab")

    def loss(pos, op, col):
        r = jax_render_prim_sharded(
            mesh, "slab", W, H, K, Rt, pos, quat, scale, op, col,
            bg_color=bg, use_pallas=use_pallas, pallas_inner=16, **KW)
        return (r["render"] ** 2).mean() + r["alpha"].mean(), r

    interp = gsplat_pallas.INTERPRET
    gsplat_pallas.INTERPRET = True
    try:
        (v, r), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(pos, op, col)
        return (float(v), {k: np.asarray(x) for k, x in r.items()},
                [np.asarray(x) for x in g])
    finally:
        gsplat_pallas.INTERPRET = interp


@pytest.mark.parametrize("nslabs, use_pallas", [(4, False), (3, True)])
def test_render_prim_sharded_matches_jax(nslabs, use_pallas):
    """Outputs (with a background colour, applied after the fold), the
    loss and its gradients (pos, op, col) of the slab render on a mesh of
    ``nslabs`` shards against the JAX slab render; N = 98 pads the last
    slab."""
    ref_v, ref_r, ref_g = jax_slab_render(nslabs, use_pallas)
    K, Rt, pos, quat, scale, op, col, bg = map(torch.from_numpy, scene())
    leaves = [x.clone().requires_grad_(True) for x in (pos, op, col)]
    mesh = Mesh(["cpu"] * nslabs, ("slab",))
    r = render_prim_sharded(mesh, "slab", W, H, K, Rt, leaves[0], quat,
                            scale, leaves[1], leaves[2], bg_color=bg,
                            use_pallas=use_pallas, pallas_inner=16, **KW)
    v = (r["render"] ** 2).mean() + r["alpha"].mean()
    v.backward()
    assert N % nslabs
    assert set(r) == set(ref_r)
    for key in ref_r:
        assert tuple(r[key].shape) == ref_r[key].shape, key
        np.testing.assert_allclose(r[key].detach().numpy(), ref_r[key],
                                   atol=5e-5, err_msg=key)
    # rtol 2e-4 as tests/test_tile_shard.py: XLA's float32 mean over the
    # image is ~2e-5 from a float64 one here, the port's ~1e-7
    np.testing.assert_allclose(v.item(), ref_v, rtol=2e-4)
    for leaf, ref, name in zip(leaves, ref_g, ("pos", "op", "col")):
        s = np.abs(ref).max() + 1e-8
        assert s > 1e-6, name
        np.testing.assert_allclose(leaf.grad.numpy() / s, ref / s,
                                   atol=2e-4, err_msg=name)
    assert float(r["alpha"].detach().max()) > 0.5


def test_composite_over_matches_jax():
    """The over-operator on three slabs against the JAX function, folded
    both ways (it is associative)."""
    rs = np.random.RandomState(0)
    c = [rs.uniform(0, 1, (2, 3, 4, 4)).astype(np.float32) for _ in range(3)]
    t = [rs.uniform(0.1, 1, (2, 4, 4)).astype(np.float32) for _ in range(3)]
    tc = [torch.from_numpy(x) for x in c]
    tt = [torch.from_numpy(x) for x in t]
    jc = [jnp.asarray(x) for x in c]
    jt = [jnp.asarray(x) for x in t]
    left = composite_over(composite_over((tc[0], tt[0]), (tc[1], tt[1])),
                          (tc[2], tt[2]))
    right = composite_over((tc[0], tt[0]),
                           composite_over((tc[1], tt[1]), (tc[2], tt[2])))
    ref = jax_composite_over(
        jax_composite_over((jc[0], jt[0]), (jc[1], jt[1])), (jc[2], jt[2]))
    for got in (left, right):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-6)
