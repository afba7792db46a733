"""Parity of the port's compositor backward (K2's and K3's plain versions,
the per-prim reduce and the whole VJP of ``render``) with the JAX package on
the CPU, the Pallas kernels in interpret mode.

Tolerances: rtol 1e-4 on the per-pair gradients, with atol 1e-4 of each
column's largest entry: both sides run float32 and take the same sums over
a tile's pixels in other orders (the Pallas kernel takes its prefixes as
triangular matmuls in log space, the plain version as cumprod/cumsum), and
the suffix-from-total identity cancels terms of the size of the column's
largest. Scans: rtol 1e-5, atol 1e-3, as the JAX package's own test holds
its kernel to numpy. Gradients of ``render``: rtol 1e-3 and atol 1e-3 of
each gradient's largest entry (the per-prim sums are differences of float32
prefixes over the whole pair budget on both sides, in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat as tg
from goliath_torch.ops import gsplat_cuda
from goliath_tpu.ops import gsplat as jg
from goliath_tpu.ops import gsplat_pallas

from test_torch_gsplat import _scene

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_cols(got, ref, rtol, atol_of_max, name):
    """Column-wise allclose with atol scaled by each column's largest |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    for k in range(ref.shape[-1]):
        scale = max(float(np.abs(ref[..., k]).max()), 1e-30)
        np.testing.assert_allclose(
            got[..., k], ref[..., k], rtol=rtol, atol=atol_of_max * scale,
            err_msg=f"{name} column {k}")


@pytest.mark.parametrize("opaque,maxpp,chunk", [
    (False, 256, 32),    # no tile overflows, no early-out
    (True, 64, 16),      # overflowing tiles and the T early-out
])
def test_pair_grads_plain_matches_pallas_kernel(opaque, maxpp, chunk):
    """K2's plain version against the Pallas K2 (interpret mode) on the same
    packed rows, forward outputs and upstream gradients: all 16 columns."""
    rng = np.random.RandomState(2)
    H, W, ts = 48, 64, 16
    K, Rt, means, quats, scales, opac, colors = _scene(rng, 1, 150, H, W,
                                                       opaque)
    xys, conics, op_s, chan, valid, _radii, b = jg.prepare_sample(
        *map(jnp.asarray, (K[0], Rt[0], means[0], quats[0], scales[0],
                           opac[0], colors[0])), H, W, ts, pair_budget=600)
    ntx, nty = -(-W // ts), -(-H // ts)
    nchunks = maxpp // chunk + 1
    rows = gsplat_pallas.pack_pair_rows(
        xys, conics, op_s, chan, valid.astype(jnp.float32), b.sorted_prim,
        nchunks * chunk)
    out, T, cnt = gsplat_pallas.rasterize_tiled_pallas_fwd(
        xys, conics, op_s, chan, valid.astype(jnp.float32), b.sorted_prim,
        b.tile_start, b.tile_end, H, W, ts, ntx, nty, chunk=chunk, inner=8,
        max_pairs_per_tile=maxpp, interpret=True, rows_packed=rows)
    C = chan.shape[1]
    d_out = rng.randn(C, H, W).astype(np.float32)
    d_T = rng.randn(H, W).astype(np.float32)
    ref = gsplat_pallas.pair_grads_pallas(
        None, None, op_s, chan, None, b.sorted_prim, b.tile_start,
        b.tile_end, b.tile_of_pair, jnp.asarray(d_out), jnp.asarray(d_T), T,
        cnt, H, W, ts, ntx, nty, chunk=chunk, inner=8,
        max_pairs_per_tile=maxpp, interpret=True, rows_packed=rows,
        out_img=out)
    got = gsplat_cuda.pair_grads(
        _t(rows), _t(b.tile_start), _t(b.tile_end), _t(cnt), _t(d_out),
        _t(d_T), _t(T), ts, ntx, nty, chunk, b.sorted_prim.shape[0])
    assert got.shape == (600, 16)
    # The Pallas kernel leaves the blocks it never visits unwritten (NaN in
    # interpret mode): slots past the last tile's end, and blocks wholly
    # past the window of an overflowing tile. The port zero-fills them.
    ref = np.asarray(ref)
    written = np.isfinite(ref).all(axis=1)
    start, end = np.asarray(b.tile_start), np.asarray(b.tile_end)
    reached = np.zeros(600, bool)    # rows inside some tile's block window
    for s0, e0 in zip(start, end):
        reached[s0:min(e0, (s0 // chunk + nchunks) * chunk)] = True
    assert reached.any() and written[reached].all()
    assert not got[~written].any() and not got[~reached].any()
    got, ref = got[written], ref[written]
    _close_cols(got, ref, 1e-4, 1e-4, "pair grads")
    assert np.abs(ref).max() > 1e-3               # the case has gradients
    assert not got[:, 6 + C:].any()               # zero pad columns
    if opaque:  # the case must exercise both truncation and the early-out
        counts = np.asarray(b.tile_end - b.tile_start)
        assert counts.max() > maxpp
        assert (np.asarray(cnt) < nchunks).any()


def test_cumsum_cols_plain_matches_pallas_kernel():
    rng = np.random.RandomState(3)
    cols = [rng.standard_normal(3000).astype(np.float32) for _ in range(5)]
    ref = gsplat_pallas.cumsum_cols_pl([jnp.asarray(c) for c in cols],
                                       rows=4, lanes=128, interpret=True)
    got = gsplat_cuda.cumsum_cols(torch.from_numpy(np.stack(cols)))
    assert got.shape == (5, 3000)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
    with pytest.raises(ValueError, match="float32"):
        gsplat_cuda.cumsum_cols(torch.zeros(3, 4, dtype=torch.int32))


def test_reduce_sorted_pair_grads_matches_jax():
    """Random pair grads, a random permutation, prims with 0..8 pairs and
    unused slots past the last prim."""
    rng = np.random.RandomState(4)
    budget, F, N = 4096, 10, 300
    sorted_g = rng.standard_normal((budget, F)).astype(np.float32)
    perm = rng.permutation(budget).astype(np.int32)
    counts = rng.randint(0, 9, N).astype(np.int32)
    assert counts.sum() < budget
    ends = np.cumsum(counts).astype(np.int32)
    offsets = (ends - counts).astype(np.int32)
    ref = jg.reduce_sorted_pair_grads(*map(jnp.asarray, (
        sorted_g, perm, offsets, ends)))
    got = tg.reduce_sorted_pair_grads(*map(torch.from_numpy, (
        sorted_g, perm, offsets, ends)))
    assert got.shape == (F, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


_RENDER_CASES = {
    # tiles under max_pairs_per_tile, translucent: no early-out
    "plain": dict(opaque=False, N=80, kw=dict(
        tile_size=16, max_pairs_per_tile=256, chunk=32, pallas_inner=16,
        pair_budget_mult=4)),
    # opaque Gaussians: tiles saturate and later blocks are skipped
    "early_out": dict(opaque=True, N=150, kw=dict(
        tile_size=16, max_pairs_per_tile=256, chunk=16, pallas_inner=8,
        pair_budget_mult=4)),
}


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


def _brute_force_warp_visits(rows, start, end, cnt, H, W, ts, chunk, C):
    """(kept, {map: (pair, warp) visits}) by a loop over tiles, the blocks
    j < cnt[t] of each tile's Pallas window and their rows, with each
    design's pixels of a warp laid out as the kernels lay out their threads:
    the first design one pixel a thread in row order; the current one
    ``ppt`` pixels a thread, warp w over a region of ``rw`` x 8 pixels,
    lane l at column l % rw and rows l // rw + k * (32 // rw)."""
    ntx = -(-W // ts)
    rw = 16 if ts % 16 == 0 else 8
    ppt = rw // 4
    n_warps = ts * ts // (32 * ppt)
    cur = np.zeros((n_warps, 32 * ppt, 2), np.int64)     # (x, y) in the tile
    for p in range(32 * n_warps):
        warp, lane = divmod(p, 32)
        for k in range(ppt):
            cur[warp, lane * ppt + k] = (
                (warp % (ts // rw)) * rw + lane % rw,
                (warp // (ts // rw)) * 8 + lane // rw + k * (32 // rw))
    yy, xx = np.divmod(np.arange(ts * ts), ts)
    first_design = np.stack([xx, yy], -1).reshape(-1, 32, 2)
    kept, visits = 0, {"row32": 0, "regions": 0}
    for t in range(len(start)):
        x0, y0 = (t % ntx) * ts, (t // ntx) * ts
        px = torch.arange(ts).float() + x0 + 0.5
        py = torch.arange(ts).float() + y0 + 0.5
        inside = ((px[None, :] < W) & (py[:, None] < H)).numpy()   # [y, x]
        base0 = (int(start[t]) // chunk) * chunk
        for j in range(int(cnt[t])):
            lo = max(base0 + j * chunk, int(start[t]))
            hi = min(base0 + (j + 1) * chunk, int(end[t]))
            for r in range(lo, hi):
                d = rows[r]
                dx = d[0] - px[None, :]
                dy = d[1] - py[:, None]
                sigma = 0.5 * (d[2] * dx * dx + d[4] * dy * dy) \
                    + d[3] * dx * dy
                raw = d[5] * torch.exp(-sigma.clamp(0.0, 60.0))
                alpha = raw.clamp(max=gsplat_cuda.ALPHA_CLIP)
                keep = ((sigma >= 0) & (alpha >= gsplat_cuda.ALPHA_MIN)
                        ).numpy()                                 # [y, x]
                kept += int((keep & inside).sum())
                for w in first_design:
                    visits["row32"] += bool(keep[w[:, 1], w[:, 0]].any())
                for w in cur:
                    visits["regions"] += bool(
                        (keep & inside)[w[:, 1], w[:, 0]].any())
    return kept, visits


@pytest.mark.parametrize("ts", [8, 16])
def test_pair_grads_plain_counts_warp_visits(ts):
    """The warp-visit and shuffle counts of ``pair_grads_plain`` against a
    brute-force loop, on a frame with an overflowing tile (the Pallas
    window cuts it) and partial edge tiles (76 = 4 * 16 + 12 = 9 * 8 + 4
    columns)."""
    rng = np.random.RandomState(7)
    H, W, maxpp, chunk = 40, 76, 64, 16
    K, Rt, *prims = _scene(rng, 1, 150, H, W, True)
    xys, conics, op_s, chan, valid, _r, b = tg.prepare_sample(
        *(torch.from_numpy(a[0]) for a in (K, Rt, *prims)), H, W, ts,
        pair_budget=1200)
    ntx, nty = -(-W // ts), -(-H // ts)
    rows = gsplat_cuda.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                                      b.sorted_prim,
                                      (maxpp // chunk + 1) * chunk)
    img, T, cnt = gsplat_cuda.compositor_fwd_plain(
        rows, b.tile_start, b.tile_end, H, W, ts, ntx, nty, chunk, maxpp)
    assert int((b.tile_end - b.tile_start).max()) > maxpp
    assert W % ts
    C = chan.shape[1]
    g = np.random.RandomState(8)
    counts = {}
    gsplat_cuda.pair_grads_plain(
        rows, b.tile_start, b.tile_end, cnt,
        torch.from_numpy(g.randn(C, H, W).astype(np.float32)),
        torch.from_numpy(g.randn(H, W).astype(np.float32)), T, ts, ntx, nty,
        chunk, 1200, counts=counts)
    kept, visits = _brute_force_warp_visits(
        rows, b.tile_start, b.tile_end, cnt, H, W, ts, chunk, C)
    assert int(counts["kept"]) == kept > 0
    for d in gsplat_cuda.K2_WARP_MAPS:
        assert int(counts["warp_visits"][d]) == visits[d] > 0, d
        assert int(counts["shuffles"][d]) == visits[d] * (
            5 * (6 + C) if d == "row32" else 32), d
    # the current design's warps hold 2-4x the pixels: fewer visits
    assert visits["regions"] < visits["row32"]


def test_fold_grads_check_capture_and_shares(monkeypatch):
    """fold_grads_check keeps the batch-folded pair_grads calls only, with
    GOLIATH_GSPLAT_FOLD=1 inside its block and the variable and the function
    restored after; its shares (chip_smoke's tolerance) are 0 for equal
    gradients and over 1, in that column alone, for one entry moved past
    the tolerance."""
    import importlib.util
    import os

    from goliath_torch.scripts import fold_grads_check as fgc

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", fgc.ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.delenv("GOLIATH_GSPLAT_FOLD", raising=False)
    seen, store = [], []

    def pair_grads(*args):
        seen.append(args)
        return args[-2]

    monkeypatch.setattr(gsplat_cuda, "pair_grads", pair_grads)
    with fgc.CaptureFold(gsplat_cuda, store):
        assert os.environ["GOLIATH_GSPLAT_FOLD"] == "1"
        assert gsplat_cuda.pair_grads(torch.ones(2), 3, 4, "pallas") == 4
        assert gsplat_cuda.pair_grads(torch.ones(2), 3, 1, "xla") == 1
    assert "GOLIATH_GSPLAT_FOLD" not in os.environ
    assert gsplat_cuda.pair_grads is pair_grads
    assert len(seen) == 2 and len(store) == 1 and store[0][-2:] == (4, "pallas")

    g = torch.Generator().manual_seed(0)
    ref = torch.randn(200, 16, generator=g)
    ref[:, 10:] = 0
    ref[150:] = 0                          # rows without a gradient
    assert all(s == 0 and n == 0
               for s, n in fgc.column_shares(cs, ref.clone(), ref, 10))
    got = ref.clone()
    got[7, 3] += 1.0
    shares = fgc.column_shares(cs, got, ref, 10)
    assert shares[3][0] > 1 and shares[3][1] == 1
    assert all(s == 0 and n == 0
               for k, (s, n) in enumerate(shares) if k != 3)
