"""Parity of the port's mesh rasterizer (ops/rasterizer.py, and K5's plain
version in ops/rasterizer_cuda.py) with the JAX package on the CPU.

The JAX side runs eagerly here, as the JAX package's own tests/test_rasterizer.py
runs it. Under ``jax.jit`` XLA on the CPU contracts products and sums into
fused multiply-adds: the sphere fixture's pole fans (faces with two equal
corners, whose area is exactly 0 when each product is rounded) then get
areas of ~1e-3 px^2, pass the ``|area| > 1e-12`` test and win pixels with
inverse areas of ~1e3 (358 of 3,072 pixels of the 48x64 scene below change).
The port, like the eager JAX package and the exact reference, rounds each
product on its own (the CUDA kernel by ``__fmul_rn``/``__fadd_rn``).

Tolerances: face indices of the z-buffer exactly; its depths at rtol
1e-5 (interpret mode compiles the Pallas kernel's body, and XLA fuses its
sums of products there; no pixel's nearest face changes in these scenes);
transform, barycentrics, depth,
interpolated attributes and the rendered image at atol/rtol 1e-5 where the
face agrees (the same formulas; the 3x3 products of ``transform`` sum in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import rasterizer as tr
from goliath_torch.ops import rasterizer_cuda as rc
from goliath_tpu.data.synthetic import make_camera_ring, make_sphere_mesh
from goliath_tpu.ops import rasterizer as jr
from goliath_tpu.ops import rasterizer_pallas as jrp

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
GRAD_RTOL = 1e-4
H, W = 48, 64


def _scene(n_lat=6, n_lon=8):
    v, vi, vt, vti = make_sphere_mesh(n_lat, n_lon, radius=100.0)
    K, Rt, _ = make_camera_ring(1, H, W)
    v_pix = np.asarray(jr.transform(jnp.asarray(v[None]), jnp.asarray(K),
                                    jnp.asarray(Rt))[0])
    return v, vi, vt, vti, K, Rt, v_pix


@pytest.mark.parametrize("mfpt,chunk", [
    (128, 16),   # no tile overflows
    (16, 8),     # tiles overflow: the chunk-aligned window cuts them
])
def test_zbuffer_plain_matches_the_pallas_kernel(mfpt, chunk):
    """K5's plain version against ``rasterize_zbuffer_pallas`` in interpret
    mode on the same rows and binning: face index and depth equal on every
    pixel; the whole ``rasterize`` too. Where tiles overflow, the XLA scan
    (``use_pallas=False``, the JAX package's default off the TPU) differs,
    in overflowing tiles only."""
    _v, vi, _vt, _vti, _K, _Rt, v_pix = _scene()
    tv, tvi = torch.from_numpy(v_pix.copy()), torch.from_numpy(vi)
    rows, b = tr.bin_faces(tv, tvi, H, W, 16)
    ntx, nty = b.num_tiles_x, b.num_tiles_y
    got_idx, got_z = rc.zbuffer(rows, b.sorted_prim, b.tile_start,
                                b.tile_end, H, W, 16, ntx, nty, chunk, mfpt)
    r = rows.numpy()
    sp = b.sorted_prim.numpy()
    # the Pallas launcher gathers per-face columns by sorted_prim; hand it
    # the rows as faces (face s = row s) so both read the same numbers
    ref_idx, ref_z = jrp.rasterize_zbuffer_pallas(
        jnp.asarray(r[:, 0:3]), jnp.asarray(r[:, 3:6]), jnp.asarray(r[:, 6:9]),
        jnp.asarray(r[:, 9]), jnp.asarray(r[:, 10:13]),
        jnp.ones(len(r), jnp.float32), jnp.arange(len(r), dtype=jnp.int32),
        jnp.asarray(b.tile_start.numpy()), jnp.asarray(b.tile_end.numpy()),
        H, W, 16, ntx, nty, chunk=chunk, inner=chunk,
        max_faces_per_tile=mfpt, interpret=True)
    ref_idx = np.asarray(ref_idx)
    np.testing.assert_array_equal(got_idx.numpy(),
                                  np.where(ref_idx >= 0, sp[ref_idx], -1))
    # interpret mode compiles the kernel body, and XLA contracts its sums of
    # products into FMAs there: the depths agree to float32 rounding
    np.testing.assert_allclose(got_z.numpy(), np.asarray(ref_z), rtol=RTOL)

    port = tr.rasterize(tv, tvi, H, W, max_faces_per_tile=mfpt,
                        chunk=chunk).numpy()
    pallas = np.asarray(jr.rasterize(
        jnp.asarray(v_pix), jnp.asarray(vi), H, W, max_faces_per_tile=mfpt,
        chunk=chunk, pallas_inner=chunk, use_pallas=True, interpret=True))
    np.testing.assert_array_equal(port, pallas)
    assert float((port != -1).mean()) > 0.2

    scan = np.asarray(jr.rasterize(jnp.asarray(v_pix), jnp.asarray(vi), H, W,
                                   max_faces_per_tile=mfpt, chunk=chunk))
    pairs = (b.tile_end - b.tile_start).numpy().reshape(nty, ntx)
    over = np.kron(pairs > mfpt, np.ones((16, 16), bool))[:H, :W]
    assert over.any() == (mfpt == 16)
    np.testing.assert_array_equal(port[~over], scan[~over])
    if over.any():
        assert (port[over] != scan[over]).sum() > 0


def test_rasterize_reference_matches_jax():
    _v, vi, _vt, _vti, _K, _Rt, v_pix = _scene()
    got = tr.rasterize_reference(torch.from_numpy(v_pix),
                                 torch.from_numpy(vi), H, W).numpy()
    ref = np.asarray(jr.rasterize_reference(jnp.asarray(v_pix),
                                            jnp.asarray(vi), H, W))
    np.testing.assert_array_equal(got, ref)
    tiled = tr.rasterize(torch.from_numpy(v_pix), torch.from_numpy(vi), H, W,
                         max_faces_per_tile=128, chunk=16).numpy()
    assert ((tiled == -1) == (ref == -1)).all()
    assert (tiled == ref).mean() > 0.995


def test_transform_barys_and_interpolate_match_jax():
    v, vi, _vt, _vti, K, Rt, v_pix = _scene()
    verts = (v[None] + np.random.RandomState(0).randn(1, *v.shape)
             ).astype(np.float32)
    got_vp = tr.transform(torch.from_numpy(verts), torch.from_numpy(K),
                          torch.from_numpy(Rt))
    np.testing.assert_allclose(
        got_vp.numpy(), np.asarray(jr.transform(
            jnp.asarray(verts), jnp.asarray(K), jnp.asarray(Rt))),
        atol=1e-4, rtol=RTOL)  # pixel coordinates ~1e2, depths ~4e2
    tvp, tvi = torch.from_numpy(v_pix), torch.from_numpy(vi)
    idx = tr.rasterize(tvp, tvi, H, W, max_faces_per_tile=128, chunk=16)
    depth, bary = tr.render_barys(tvp, tvi, idx)
    j_depth, j_bary = jr.render_barys(jnp.asarray(v_pix), jnp.asarray(vi),
                                      jnp.asarray(idx.numpy()))
    np.testing.assert_allclose(bary.numpy(), np.asarray(j_bary), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j_depth), rtol=RTOL)
    attrs = np.random.RandomState(1).randn(len(v_pix), 5).astype(np.float32)
    np.testing.assert_allclose(
        tr.interpolate(torch.from_numpy(attrs), tvi, idx, bary).numpy(),
        np.asarray(jr.interpolate(jnp.asarray(attrs), jnp.asarray(vi),
                                  jnp.asarray(idx.numpy()), j_bary)),
        atol=ATOL, rtol=RTOL)
    # screen xy interpolates back to the pixel centres
    xy = tr.interpolate(tvp[:, :2], tvi, idx, bary).numpy()
    py, px = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    m = idx.numpy() != -1
    assert np.abs(xy[0][m] - px[m]).max() < 1e-2
    assert np.abs(xy[1][m] - py[m]).max() < 1e-2
