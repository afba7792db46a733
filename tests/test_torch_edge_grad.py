"""Parity of the port's edge-gradient backward (ops/rasterizer.py
``EdgeGradEstimator`` / ``edge_grads``) with ``jax.vjp`` of the JAX
package's ``edge_grad_estimator`` on the CPU, per sample, at 48x48.

The estimator reads its image, face index, depth and barycentric images as
given, so the synthetic cases draw them directly: faces in patches (pairs
on one face give nothing), background pixels (index -1) whose depth is a
finite number the estimator must replace by BIG_DEPTH, and depths taken
from a few levels, so that many pairs on two faces tie (the second pixel
of a tie is the front). The rendered case takes the images of a sphere
that the port rasterized, a batch of 2.

Tolerance: rtol 1e-5 plus 1e-6 of the largest |reference| entry. The
scatter adds in the same order on both sides on the CPU; the channel sums
<g, img_a - img_b> may be associated in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import rasterizer as tr
from goliath_tpu.data.synthetic import make_camera_ring, make_sphere_mesh
from goliath_tpu.ops import rasterizer as jr

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

H = W = 48
RTOL, ATOL_OF_MAX = 1e-5, 1e-6


def _jax_grads(v_pix, vi, bary, img, idx, depth, g):
    """(d v_pix, d img) of one sample through the JAX custom VJP."""
    def f(vp, im):
        return jr.edge_grad_estimator(vp, jnp.asarray(vi), jnp.asarray(bary),
                                      im, jnp.asarray(idx),
                                      jnp.asarray(depth))

    _, vjp = jax.vjp(f, jnp.asarray(v_pix), jnp.asarray(img))
    g_vp, g_img = vjp(jnp.asarray(g))
    return np.asarray(g_vp), np.asarray(g_img)


def _torch_grads(v_pix, vi, bary, img, idx, depth, g):
    """(d v_pix, d img) of a batch through the port's estimator."""
    vp = torch.from_numpy(v_pix).requires_grad_(True)
    im = torch.from_numpy(img).requires_grad_(True)
    out = tr.edge_grad_estimator(vp, torch.from_numpy(vi),
                                 torch.from_numpy(bary), im,
                                 torch.from_numpy(idx),
                                 torch.from_numpy(depth))
    assert torch.equal(out, im)
    out.backward(torch.from_numpy(g))
    return vp.grad.numpy(), im.grad.numpy()


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(
        got, ref, rtol=RTOL,
        atol=ATOL_OF_MAX * max(float(np.abs(ref).max()), 1e-30),
        err_msg=err_msg)


def _synthetic(seed, n_faces=40, n_verts=30, C=4, levels=3):
    """One sample's estimator inputs drawn at random: 3x3 patches of one
    face, a quarter of the patches background, half of the depths from
    ``levels`` values and the other half constant per patch."""
    rs = np.random.RandomState(seed)
    patch = rs.randint(0, n_faces, (H // 3, W // 3))
    patch[rs.rand(*patch.shape) < 0.25] = -1
    idx = np.kron(patch, np.ones((3, 3), np.int64)).astype(np.int32)
    depth = (rs.randint(1, levels + 1, (H, W)) * 10.0).astype(np.float32)
    depth = np.where(rs.rand(H, W) < 0.5, depth,
                     np.kron(patch * 1.0 + 50.0, np.ones((3, 3)))
                     ).astype(np.float32)
    bary = rs.dirichlet(np.ones(3), (H, W)).transpose(2, 0, 1).astype(
        np.float32)
    vi = rs.randint(0, n_verts, (n_faces, 3)).astype(np.int32)
    v_pix = rs.randn(n_verts, 3).astype(np.float32)
    img = rs.randn(C, H, W).astype(np.float32)
    g = rs.randn(C, H, W).astype(np.float32)
    return v_pix, vi, bary, img, idx, depth, g


@pytest.mark.parametrize("seed,levels", [(0, 3), (1, 1), (2, 50)])
def test_edge_grads_match_jax_vjp(seed, levels):
    """Random images with background and equal-depth pairs (levels=1: every
    pair of the half of pixels at the shared level ties)."""
    args = _synthetic(seed, levels=levels)
    v_pix, vi, bary, img, idx, depth, g = args
    ties = background = 0
    for a, b in ((idx[:, :-1], idx[:, 1:]), (idx[:-1], idx[1:])):
        da, db = (depth[:, :-1], depth[:, 1:]) if a.shape[1] < W else \
            (depth[:-1], depth[1:])
        ties += ((a != b) & (da == db) & (a >= 0) & (b >= 0)).sum()
        background += ((a == -1) != (b == -1)).sum()
    assert background > 20 and (levels > 3 or ties > 20)
    ref_v, ref_img = _jax_grads(*args)
    got_v, got_img = _torch_grads(*(x if x is vi else x[None] for x in args))
    got_v, got_img = got_v[0], got_img[0]
    np.testing.assert_array_equal(got_img, ref_img)   # g passes through
    assert float(np.abs(ref_v[:, :2]).max()) > 0
    assert not ref_v[:, 2].any() and not got_v[:, 2].any()
    _close(got_v, ref_v)


def test_edge_grads_of_a_rendered_batch_match_jax_per_sample():
    """A batch of 2 rendered spheres (the second scaled by 1.05) through
    the batched backward, each sample against its own ``jax.vjp``."""
    v, vi, _vt, _vti = make_sphere_mesh(6, 8, radius=100.0)
    K, Rt, _ = make_camera_ring(1, H, W)
    verts = np.stack([v, v * 1.05]).astype(np.float32)
    Kb, Rtb = np.repeat(K, 2, 0), np.repeat(Rt, 2, 0)
    v_pix = tr.transform(torch.from_numpy(verts), torch.from_numpy(Kb),
                         torch.from_numpy(Rtb))
    tvi = torch.from_numpy(vi)
    idx, depth, bary = [], [], []
    for vp in v_pix:
        ii = tr.rasterize(vp, tvi, H, W, max_faces_per_tile=128, chunk=16)
        d, b = tr.render_barys(vp, tvi, ii)
        idx.append(ii)
        depth.append(d)
        bary.append(b)
    idx, depth, bary = torch.stack(idx), torch.stack(depth), torch.stack(bary)
    assert 0.2 < float((idx >= 0).float().mean()) < 0.9
    rs = np.random.RandomState(3)
    img = rs.rand(2, 4, H, W).astype(np.float32) * (idx[:, None] >= 0).numpy()
    g = rs.randn(2, 4, H, W).astype(np.float32)
    batch = (v_pix.detach().numpy(), vi, bary.numpy(), img, idx.numpy(),
             depth.numpy(), g)
    got_v, got_img = _torch_grads(*batch)
    for s in range(2):
        ref_v, ref_img = _jax_grads(*(x if x is vi else x[s] for x in batch))
        assert float(np.abs(ref_v).max()) > 0
        np.testing.assert_array_equal(got_img[s], ref_img)
        _close(got_v[s], ref_v, err_msg=f"sample {s}")
