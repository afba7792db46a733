"""Part of tests/test_torch_gsplat_bwd.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gsplat import _scene

from goliath_torch.ops import gsplat as tg, gsplat_cuda
from goliath_tpu.ops import gsplat as jg, gsplat_pallas

from tests.test_torch_gsplat_bwd import _RENDER_CASES, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("case", sorted(_RENDER_CASES))
def test_render_vjp_matches_jax_pallas_path(monkeypatch, case):
    """Gradients of a scalar of render's outputs with respect to primpos,
    primqvec, primscale, opacity and colors, against jax.grad through
    render(use_pallas=True) with the Pallas kernels interpreted."""
    monkeypatch.setattr(gsplat_pallas, "INTERPRET", True)
    spec = _RENDER_CASES[case]
    rng = np.random.RandomState(5)
    H, W = 48, 64
    K, Rt, *prims = _scene(rng, 2, spec["N"], H, W, spec["opaque"])
    w_rgb = rng.rand(2, 3, H, W).astype(np.float32)
    w_a = rng.rand(2, 1, H, W).astype(np.float32)
    w_d = rng.rand(2, 1, H, W).astype(np.float32) * 0.1

    def j_loss(*p):
        o = jg.render(W, H, jnp.asarray(K), jnp.asarray(Rt), *p,
                      use_pallas=True, **spec["kw"])
        return ((o["render"] * w_rgb).sum() + (o["alpha"] * w_a).sum()
                + (o["depth"] * w_d).sum())

    ref_val, ref = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, prims))
    tp = [torch.from_numpy(a).requires_grad_(True) for a in prims]
    o = tg.render(W, H, torch.from_numpy(K), torch.from_numpy(Rt), *tp,
                  use_pallas=True, **spec["kw"])
    val = ((o["render"] * _t(w_rgb)).sum() + (o["alpha"] * _t(w_a)).sum()
           + (o["depth"] * _t(w_d)).sum())
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-4)
    for name, t, r in zip(("primpos", "primqvec", "primscale", "opacity",
                           "colors"), tp, ref):
        r = np.asarray(r)
        assert t.grad.shape == r.shape and np.isfinite(r).all(), name
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("window", ["pallas", "xla"])
def test_rasterize_tiled_vjp_overflow_tile(window):
    """A tile with more pairs than the kernels' block window (the scene of
    the JAX package's test_pallas_overflow_tile_grads: 60 prims over tile 0,
    window 48 rows from the aligned start in the Pallas kernels, 32 from the
    tile's start in the XLA compositor, 12 prims over tile 1): gradients
    with respect to xys, conics, opacities and colors against the JAX
    custom VJP of that window (``rasterize_tiled_pl`` with the Pallas
    kernels interpreted, or the XLA ``rasterize_tiled`` with its
    back-to-front backward), and exactly zero for the prims past the
    window. The low opacities keep T far above the 1e-20 clip of the XLA
    backward's reverse product, where the two backward forms agree."""
    from goliath_tpu.ops.binning import bin_to_tiles

    rng = np.random.RandomState(6)
    H, W, ts, ntx, nty = 16, 32, 16, 2, 1
    N, n0 = 72, 60
    maxppt, chunk, inner = 32, 16, 8
    cx = np.concatenate([np.full(n0, 8.0), np.full(N - n0, 24.0)])
    xys = np.stack([cx + rng.uniform(-4, 4, N),
                    8.0 + rng.uniform(-6, 6, N)], -1).astype(np.float32)
    conics = np.tile(np.array([[0.25, 0.0, 0.25]], np.float32), (N, 1))
    op = rng.uniform(0.02, 0.08, (N, 1)).astype(np.float32)
    col = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    valid = np.ones(N, bool)
    t_min = np.floor((xys - 3.0) / ts).astype(np.int32)
    t_max = (np.floor((xys + 3.0) / ts) + 1).astype(np.int32)
    b = bin_to_tiles(jnp.asarray(t_min), jnp.asarray(t_max),
                     jnp.asarray(valid), ntx, nty, 16, 4 * N)
    start0, end0 = int(b.tile_start[0]), int(b.tile_end[0])
    if window == "pallas":
        first = (start0 // chunk) * chunk
        win_end = first + (maxppt // chunk + 1) * chunk
    else:
        win_end = start0 + (maxppt // chunk) * chunk
    assert end0 > win_end
    barrays = (b.sorted_prim, b.tile_start, b.tile_end, jnp.asarray(valid),
               b.perm, b.prim_offsets, b.prim_ends, b.tile_of_pair)

    def j_loss(xys, conics, op, col):
        if window == "pallas":
            out, T = gsplat_pallas.rasterize_tiled_pl(
                xys, conics, op, col, barrays, H, W, ts, maxppt, chunk,
                inner, ntx, nty)
        else:
            out, T = jg.rasterize_tiled(xys, conics, op, col, barrays, H, W,
                                        ts, maxppt, chunk, ntx, nty)
        return (out * out).sum() + (T * 1.7).sum()

    gsplat_pallas.INTERPRET = True
    try:
        ref_val, ref = jax.jit(jax.value_and_grad(
            j_loss, argnums=(0, 1, 2, 3)))(
                *map(jnp.asarray, (xys, conics, op, col)))
    finally:
        gsplat_pallas.INTERPRET = False

    tp = [torch.from_numpy(a).requires_grad_(True)
          for a in (xys, conics, op, col)]
    out, T = gsplat_cuda.rasterize_tiled(
        *tp, _t(valid), _t(b.sorted_prim), _t(b.tile_start), _t(b.tile_end),
        _t(b.perm), _t(b.prim_offsets), _t(b.prim_ends), H, W, ts, maxppt,
        chunk, ntx, nty, window=window)
    val = (out * out).sum() + (T * 1.7).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-4)
    over = np.asarray(b.sorted_prim)[win_end:end0]
    assert len(over) > 0
    for name, t, r in zip(("xys", "conics", "opacities", "colors"), tp, ref):
        r = np.asarray(r)
        assert np.isfinite(r).all() and np.abs(r).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * np.abs(r).max(), err_msg=name)
        assert not t.grad[over].any(), name
