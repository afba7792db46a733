"""The rest of the JAX package's utilities in the port, against the JAX
package on the CPU: ``utils/lbs.compute_normalized_pose_quat``, ``utils/image.smoothstep`` and the numpy
host helpers (``morph_erode_np``, ``tensor2rgb_np``, ``make_grid_np``,
``make_image_grid_batched`` with its label font), the free seam functions
``utils/seams.impaint_batch`` and ``resample_tex`` (on the JAX package's
seam fixture, duplicate dst texels included) and ``ops/mvp.MVPRenderOut``
(``utils/sh.eval_sh``: tests/test_torch_library_sh.py).

Tolerances: the numpy helpers bit for bit (the same numpy on both sides);
float32 outputs and gradients (``jax.grad`` against autograd) at rtol 1e-5
and atol 1e-5 of the largest entry (sums in other orders); the seam
functions at 1e-5
(the port's band arithmetic x + w (r - x) against the dense
(1 - w) x + w r).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.data import synthetic as tsyn
from goliath_torch.ops import mvp as tmvp
from goliath_torch.utils import image as timage
from goliath_torch.utils import lbs as tlbs
from goliath_torch.utils import seams as tseams
from goliath_tpu.ops import mvp as jmvp
from goliath_tpu.utils import image as jimage
from goliath_tpu.utils import lbs as jlbs
from goliath_tpu.utils import seams as jseams
from tests.test_torch_library import close

torch.set_num_threads(1)


def _grads(jfn, tfn, xs, tol=1e-5, seed=11):
    """Outputs and the gradients of every input of a seeded projection."""
    ref = jax.jit(jfn)(*[jnp.asarray(x) for x in xs])
    cot = np.random.RandomState(seed).standard_normal(
        np.shape(ref)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.vdot(jfn(*a), jnp.asarray(cot)),
                          argnums=tuple(range(len(xs)))))(
        *[jnp.asarray(x) for x in xs])
    tx = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    got = tfn(*tx)
    close(got, ref, tol, "forward")
    (got * torch.from_numpy(cot)).sum().backward()
    for i, (t, j) in enumerate(zip(tx, jg)):
        close(t.grad, j, tol, f"gradient of input {i}")
    return got


def test_compute_normalized_pose_quat_matches_jax():
    v, vi, vt, vti = tsyn.make_sphere_mesh(6, 8)
    model, cfg = tsyn.make_synthetic_lbs(v, vi, vt, vti, 4)
    jl_ = jlbs.LinearBlendSkinning(model, cfg)
    tl_ = tlbs.LinearBlendSkinning(model, cfg, device="cpu")
    rng = np.random.RandomState(7)
    n_local = tl_.param_transform.nr_position_params - 6
    local = (0.4 * rng.randn(3, n_local)).astype(np.float32)
    scale = (0.1 * rng.randn(3, tl_.param_transform.nr_scaling_params)
             ).astype(np.float32)
    got = _grads(lambda p, s: jlbs.compute_normalized_pose_quat(jl_, p, s),
                 lambda p, s: tlbs.compute_normalized_pose_quat(tl_, p, s),
                 [local, scale])
    assert got.shape == (3, tl_.num_joints, 4)


def test_smoothstep_and_host_image_helpers_match_jax():
    x = np.linspace(-0.5, 1.5, 41).astype(np.float32)   # ties at 0 and 1
    _grads(lambda t: jimage.smoothstep(0.0, 1.0, t),
           lambda t: timage.smoothstep(0.0, 1.0, t), [x])
    _grads(lambda t: jimage.smoothstep(0.2, 0.7, t),
           lambda t: timage.smoothstep(0.2, 0.7, t), [x.reshape(1, 41)])
    rng = np.random.RandomState(3)
    mask = (rng.rand(20, 24) > 0.3).astype(np.float32)
    for ks in (3, 5):
        np.testing.assert_array_equal(timage.morph_erode_np(mask, ks),
                                      jimage.morph_erode_np(mask, ks))
    imgs = rng.uniform(-0.2, 1.2, (5, 3, 6, 7)).astype(np.float32)
    for c in (1, 3):
        np.testing.assert_array_equal(timage.tensor2rgb_np(imgs[0, :c]),
                                      jimage.tensor2rgb_np(imgs[0, :c]))
    for nrow, pad in ((8, 2), (2, 0), (3, 1)):
        np.testing.assert_array_equal(timage.make_grid_np(imgs, nrow, pad),
                                      jimage.make_grid_np(imgs, nrow, pad))
    data = {"rgb": imgs * 255.0, "mask_0.5": imgs[:, :1] * 255.0,
            "depth-x": imgs[:, 0] * 255.0}
    for kw in ({}, {"max_row_hight": 4}, {"input_is_in_0_1": True}):
        got = timage.make_image_grid_batched(
            {k: v / 255.0 if kw.get("input_is_in_0_1") else v
             for k, v in data.items()}, **kw)
        ref = jimage.make_image_grid_batched(
            {k: v / 255.0 if kw.get("input_is_in_0_1") else v
             for k, v in data.items()}, **kw)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def _seam_fixture(rng, H=16, n_copy=6):
    """tests/test_core_utils.py's seam data: a band of non-zero weights and
    dst <- src copies with a duplicate dst (the last copy wins)."""
    uvs = rng.rand(H, H, 2).astype(np.float32)
    weights = np.zeros((1, H, H), np.float32)
    band = rng.rand(H, H) < 0.15
    weights[0, band] = rng.rand(band.sum()).astype(np.float32)
    dst = rng.randint(0, H, (n_copy, 2)).astype(np.int64)
    dst[1] = dst[0]
    src = rng.randint(0, H, (n_copy, 2)).astype(np.int64)
    return {"dst_ij": dst, "src_ij": src, "uvs": uvs, "weights": weights}


def test_seam_functions_match_jax():
    rng = np.random.RandomState(2)
    data = _seam_fixture(rng)
    tex = rng.randn(2, 3, 16, 16).astype(np.float32)
    dst, src = data["dst_ij"], data["src_ij"]
    uvs, w = data["uvs"], data["weights"]
    got = _grads(lambda t: jseams.impaint_batch(t, jnp.asarray(dst),
                                                jnp.asarray(src)),
                 lambda t: tseams.impaint_batch(t, dst, src), [tex])
    # a repeated dst keeps its last copy
    (r, c), (sr, sc) = dst[1], src[1]
    np.testing.assert_allclose(got[:, :, r, c].detach().numpy(),
                               tex[:, :, sr, sc], rtol=0, atol=1e-6)
    _grads(lambda t: jseams.resample_tex(t, jnp.asarray(uvs),
                                         jnp.asarray(w)),
           lambda t: tseams.resample_tex(t, uvs, w), [tex])
    _grads(lambda t: jseams.resample_tex(jseams.impaint_batch(
               t, jnp.asarray(dst), jnp.asarray(src)), jnp.asarray(uvs),
               jnp.asarray(w)),
           lambda t: tseams.resample_tex(tseams.impaint_batch(
               t, torch.from_numpy(dst), torch.from_numpy(src)),
               torch.from_numpy(uvs), torch.from_numpy(w)), [tex])
    # the sampler's stages are the free functions on its precomputed band
    s = tseams.SeamSampler(data, device="cpu")
    t = torch.from_numpy(tex)
    assert torch.equal(s.impaint(t), tseams.impaint_batch(t, dst, src))
    assert torch.equal(s.resample(t), tseams.resample_tex(t, uvs, w))
    out = tmvp.MVPRenderOut(rgba=torch.zeros(5, 4))
    assert out._fields == jmvp.MVPRenderOut._fields == ("rgba",)
    assert out.rgba.shape == (5, 4)
