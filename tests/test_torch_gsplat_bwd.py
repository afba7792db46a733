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
