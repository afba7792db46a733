"""Parity of goliath_torch.ops.gsplat / gsplat_cuda (K1's plain version)
with the JAX reference on the CPU, the Pallas kernels in interpret mode.

Tolerances: atol 1e-4 and rtol 1e-4 on colors, transmittance and depth,
the bound the port is held to. Both sides run float32 on the CPU; they
differ only in summation order (K1's plain version takes a direct cumprod
where the Pallas kernel takes exp of a log-space prefix matmul) and in the
last ulp of exp/log. Integer outputs (the processed-block count) are
compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat as tg
from goliath_torch.ops import gsplat_cuda
from goliath_tpu.ops import gsplat as jg
from goliath_tpu.ops import gsplat_pallas

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ATOL = RTOL = 1e-4


def _scene(rng, B, N, H, W, opaque=False):
    means = rng.randn(B, N, 3).astype(np.float32) * 0.3
    means[..., 2] += 2.5
    scales = (0.02 + 0.1 * rng.rand(B, N, 3)).astype(np.float32)
    quats = rng.randn(B, N, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    lo = 0.9 if opaque else 0.05
    opac = (rng.rand(B, N, 1) * (0.99 - lo) + lo).astype(np.float32)
    colors = rng.rand(B, N, 3).astype(np.float32)
    K = np.tile(np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    Rt = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
                 .astype(np.float32), (B, 1, 1))
    return K, Rt, means, quats, scales, opac, colors


def _close(got, ref, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL, err_msg=name)


def test_project_gaussians_matches_jax():
    rng = np.random.RandomState(0)
    K, Rt, means, quats, scales, *_ = _scene(rng, 1, 200, 48, 64)
    args = (means[0], scales[0], quats[0], Rt[0])
    ref = jg.project_gaussians(*map(jnp.asarray, args), K[0, 0, 0],
                               K[0, 1, 1], K[0, 0, 2], K[0, 1, 2], 48, 64)
    Kt = torch.from_numpy(K[0])
    got = tg.project_gaussians(*map(torch.from_numpy, args), Kt[0, 0],
                               Kt[1, 1], Kt[0, 2], Kt[1, 2], 48, 64)
    for k in ("xys", "depths", "radii", "radii_xy", "conics",
              "compensation", "cov3d"):
        _close(got[k], ref[k], k)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))


def test_rasterize_reference_matches_jax():
    rng = np.random.RandomState(1)
    N, H, W = 40, 16, 24
    xys = (rng.rand(N, 2) * [W, H]).astype(np.float32)
    conics = np.tile(np.array([[0.3, 0.05, 0.2]], np.float32), (N, 1))
    op = rng.rand(N, 1).astype(np.float32)
    col = rng.rand(N, 3).astype(np.float32)
    depths = rng.rand(N).astype(np.float32)
    valid = rng.rand(N) > 0.1
    args = (xys, conics, op, col, depths, valid)
    r_img, r_T = jg.rasterize_reference(*map(jnp.asarray, args), H, W)
    g_img, g_T = tg.rasterize_reference(*map(torch.from_numpy, args), H, W)
    _close(g_img, r_img, "img")
    _close(g_T, r_T, "T")


@pytest.mark.parametrize("opaque,maxpp,chunk", [
    (False, 256, 32),    # no tile overflows
    (True, 64, 16),      # overflowing tiles and the T early-out
])
def test_compositor_plain_matches_pallas_kernel(opaque, maxpp, chunk):
    """K1's plain version against the Pallas K1 (interpret mode) on the
    same packed rows: color, T and the processed-block count. The overflow
    case holds the plain version to the kernel's truncation window."""
    rng = np.random.RandomState(2)
    H, W, ts = 48, 64, 16
    K, Rt, means, quats, scales, opac, colors = _scene(rng, 1, 150, H, W,
                                                       opaque)
    xys, conics, op_s, chan, valid, _radii, b = jg.prepare_sample(
        *map(jnp.asarray, (K[0], Rt[0], means[0], quats[0], scales[0],
                           opac[0], colors[0])), H, W, ts, pair_budget=600)
    ntx, nty = -(-W // ts), -(-H // ts)
    ref_img, ref_T, ref_cnt = gsplat_pallas.rasterize_tiled_pallas_fwd(
        xys, conics, op_s, chan, valid.astype(jnp.float32), b.sorted_prim,
        b.tile_start, b.tile_end, H, W, ts, ntx, nty, chunk=chunk, inner=8,
        max_pairs_per_tile=maxpp, interpret=True)
    nchunks = maxpp // chunk + 1
    t = lambda a: torch.from_numpy(np.array(a))
    rows = gsplat_cuda.pack_pair_rows(
        t(xys), t(conics), t(op_s), t(chan), t(valid).float(),
        t(b.sorted_prim), nchunks * chunk)
    img, T, cnt = gsplat_cuda.compositor_fwd(
        rows, t(b.tile_start), t(b.tile_end), H, W, ts, ntx, nty, chunk,
        maxpp)
    _close(img, ref_img, "img")
    _close(T, ref_T, "T")
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    if opaque:  # the case must exercise both truncation and the early-out
        counts = np.asarray(b.tile_end - b.tile_start)
        assert counts.max() > maxpp
        assert (np.asarray(ref_cnt) < nchunks).any()
