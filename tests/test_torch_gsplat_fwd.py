"""K1's pixel-to-thread map, work counts and saturated-warp skip, in its
plain version (goliath_torch.ops.gsplat_cuda.compositor_fwd_plain), on the
CPU.

The K1 kernel (csrc/compositor_fwd.cu) gives each thread PPT pixels of a
warp region and lets a warp skip a block's rows once every one of its
pixels has T == 0 exactly. Here: the map covers each pixel of a tile once;
the counts of ``compositor_fwd_plain(..., counts=)`` equal a brute-force
loop over tiles, blocks and rows; and masking the skipped warps' pixels out
of the rows they skip (``skip_saturated``) changes no output bit. The
frames are built by hand: random pair rows per tile, a tile that overflows
``max_pairs_per_tile``, a partial edge tile, an empty one, and a tile
whose first rows are opaque half-planes that drive its top 8 pixel rows to
T == 0 exactly (sigma = b dx dy with a = c = 0 keeps the pixels above the
pair's y and drops the others).
"""

import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat_cuda as gc

torch.set_num_threads(1)

MAXPP, CHUNK, C = 64, 16, 4
N_OPAQUE = 20          # half-plane rows at the head of the saturating tile
TILE_ROWS = [N_OPAQUE + 30, 100, 25, 0, 40, 10]   # per tile of one image


@pytest.mark.parametrize("ts", [8, 12, 16, 24, 32])
def test_k1_pixel_map_covers_each_pixel_once(ts):
    """Each pixel of the tile sits in exactly one (warp, lane, slot); the
    thread count is the launcher's (P / 4, P / 2, or P rounded up to whole
    warps); where the tile size is a multiple of 8 the warps are K2's."""
    pixel_map = gc.k1_pixel_map(ts)
    P = ts * ts
    mine = pixel_map[pixel_map >= 0]
    assert sorted(mine.tolist()) == list(range(P))
    assert set(pixel_map.unique().tolist()) <= set(range(-1, P))
    ppt = 4 if ts % 16 == 0 else 2 if ts % 8 == 0 else 1
    assert pixel_map.shape[1:] == (32, ppt)
    threads = pixel_map.shape[0] * 32
    assert threads == (P // ppt if ppt > 1 else -(-P // 32) * 32)
    if ppt > 1:
        assert torch.equal(gc.k1_pixel_warps(ts), gc.k2_warp_map(ts,
                                                                  "regions"))
        # a thread's pixels share a column
        assert bool(((pixel_map % ts) == (pixel_map[..., :1] % ts)).all())


def _frame(ts, n_imgs=1, seed=0):
    """Pair rows [R, 8 + C] and tile bounds of ``n_imgs`` images of 2 x 3
    tiles, the last tile column partial (W = 3 ts - 5)."""
    rng = np.random.RandomState(seed + ts)
    H, W, ntx, nty = 2 * ts, 3 * ts - 5, 3, 2
    blocks, counts = [], []
    for _img in range(n_imgs):
        for t, n in enumerate(TILE_ROWS):
            x0, y0 = (t % ntx) * ts, (t // ntx) * ts
            r = np.zeros((n, 8 + C), np.float32)
            r[:, 0] = x0 + rng.uniform(-0.5, 1.5, n) * ts
            r[:, 1] = y0 + rng.uniform(-0.5, 1.5, n) * ts
            r[:, 2] = rng.uniform(0.02, 0.3, n)
            r[:, 3] = rng.uniform(-0.01, 0.01, n)
            r[:, 4] = rng.uniform(0.02, 0.3, n)
            r[:, 5] = rng.uniform(0.05, 0.6, n)
            r[:, 8:] = rng.rand(n, C)
            if t == 0:   # opaque half-planes over the tile's top 8 rows
                r[:N_OPAQUE, :6] = [x0 - 100.0, y0 + 8.0, 0.0, -1e-7, 0.0,
                                    1.0]
            blocks.append(r)
            counts.append(n)
    rows = torch.from_numpy(np.concatenate(blocks))
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int32)
    starts = ends - torch.tensor(counts, dtype=torch.int32)
    pad = (MAXPP // CHUNK + 1) * CHUNK
    rows = torch.cat([rows, rows.new_zeros(pad, 8 + C)])
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=ntx, nty=nty, chunk=CHUNK,
              max_pairs_per_tile=MAXPP, n_imgs=n_imgs)
    return rows, starts, ends, kw


def _brute_force_counts(rows, starts, ends, cnt, kw, window):
    """K1's work tile by tile, block by block, row by row: evaluations,
    (row, warp) visits, and visits of warps whose pixels all had T == 0
    (T in float32, pixel by pixel, row by row) at their block's start; and
    each tile's final T ([tiles, 1, P]) and block count. With ``cnt`` None
    the loop stops by the window's own rule (past the tile's end, or the
    Pallas early-out: no pixel of the tile above T = 1e-4), else after
    cnt[t] blocks."""
    ts, ntx, chunk = kw["tile_size"], kw["ntx"], kw["chunk"]
    nblocks = gc.window_blocks(kw["max_pairs_per_tile"], chunk, window)
    owner = gc.k1_pixel_warps(ts)
    n_warps = int(owner.max()) + 1
    pix = torch.arange(ts * ts)
    evals, visits, skipped, Ts, cnts = [], [], [], [], []
    for t in range(len(starts)):
        start, end = int(starts[t]), int(ends[t])
        local = t % (ntx * kw["nty"])
        px = ((local % ntx) * ts + pix % ts).float() + 0.5
        py = ((local // ntx) * ts + pix // ts).float() + 0.5
        first = start if window == "xla" else start // chunk * chunk
        T = torch.ones(ts * ts)
        e = v = s = c = 0
        for j in range(nblocks if cnt is None else int(cnt[t])):
            if cnt is None and (first + j * chunk >= end or (
                    window == "pallas" and not bool((T > gc.T_EPS).any()))):
                break
            c = j + 1
            lo = max(first + j * chunk, start)
            hi = min(first + (j + 1) * chunk, end)
            sat = sum(bool((T[owner == w] == 0).all())
                      for w in range(n_warps))
            for r in range(lo, hi):
                d = rows[r]
                dx, dy = d[0] - px, d[1] - py
                sigma = 0.5 * (d[2] * dx * dx + d[4] * dy * dy) \
                    + d[3] * dx * dy
                alpha = (d[5] * torch.exp(-sigma.clamp(0.0, 60.0))).clamp(
                    max=gc.ALPHA_CLIP)
                keep = (sigma >= 0) & (alpha >= gc.ALPHA_MIN)
                T = torch.where(keep, T * (1.0 - alpha), T)
                e += ts * ts
                v += n_warps
                s += sat
        evals.append(e)
        visits.append(v)
        skipped.append(s)
        Ts.append(T)
        cnts.append(c)
    return evals, visits, skipped, torch.stack(Ts)[:, None], cnts


@pytest.mark.parametrize("window", ["pallas", "xla"])
@pytest.mark.parametrize("ts", [8, 12, 16])
def test_compositor_plain_counts_match_brute_force(ts, window):
    """Per tile and in total; the frame has an overflowing tile, a partial
    edge tile, an empty tile and a tile whose top rows reach T == 0."""
    rows, starts, ends, kw = _frame(ts)
    counts = {}
    _img, T, cnt = gc.compositor_fwd_plain(rows, starts, ends, window=window,
                                           counts=counts, **kw)
    evals, visits, skipped, _T, _cnt = _brute_force_counts(
        rows, starts, ends, cnt, kw, window)
    per_tile = counts["per_tile"]
    assert per_tile["evals"].tolist() == evals
    assert per_tile["warp_visits"].tolist() == visits
    assert per_tile["skipped_visits"].tolist() == skipped
    assert (counts["evals"], counts["warp_visits"],
            counts["skipped_visits"]) == (sum(evals), sum(visits),
                                          sum(skipped))
    assert int((ends - starts).max()) > MAXPP
    assert kw["img_w"] % ts
    assert bool((T[:8] == 0).any())
    # a 1-warp tile (ts 8) saturates whole, and the Pallas early-out then
    # stops it before any skip; the XLA window has no early-out
    assert (skipped[0] > 0) == (ts > 8 or window == "xla")


@pytest.mark.parametrize("window,n_imgs", [("pallas", 1), ("xla", 1),
                                           ("pallas", 2)])
@pytest.mark.parametrize("ts", [8, 12, 16])
def test_compositor_plain_T_is_sequential(ts, window, n_imgs):
    """The plain version's T is the kernel's bit for bit: T * (1 - alpha)
    rounded one kept pair at a time, front to back, in a brute-force loop
    over tiles, blocks and rows that applies the window's early-out itself.
    So the plain version's early-out and cnt are the kernel's exactly, even
    where a tile's largest T lies within rounding of 1e-4."""
    rows, starts, ends, kw = _frame(ts, n_imgs)
    _img, T, cnt = gc.compositor_fwd_plain(rows, starts, ends, window=window,
                                           **kw)
    *_work, T_tiles, ref_cnt = _brute_force_counts(rows, starts, ends, None,
                                                   kw, window)
    assert cnt.tolist() == ref_cnt
    ref = gc._tiles_to_image(T_tiles, kw["ntx"], kw["nty"], ts, kw["img_h"],
                             kw["img_w"])[:, 0]
    assert torch.equal(T.view(torch.int32),
                       ref.reshape(T.shape).view(torch.int32))
    # the frame exercises both ends: T == 0 exactly, and T left above 1e-4
    assert bool((T == 0).any()) and bool((T > gc.T_EPS).any())


def _brute_force_forward(rows, starts, ends, cnt, kw):
    """Colour [C, H, W] and T [H, W] of one image, pixel by pixel and row by
    row in float32 over each tile's cnt blocks (Pallas window), with torch
    operations that autograd follows."""
    ts, ntx, chunk = kw["tile_size"], kw["ntx"], kw["chunk"]
    pix = torch.arange(ts * ts)
    accs, Ts = [], []
    for t in range(len(starts)):
        start, end = int(starts[t]), int(ends[t])
        px = ((t % ntx) * ts + pix % ts).float() + 0.5
        py = ((t // ntx) * ts + pix // ts).float() + 0.5
        T = torch.ones(ts * ts)
        acc = torch.zeros(C, ts * ts)
        first = start // chunk * chunk
        for r in range(start, min(first + int(cnt[t]) * chunk, end)):
            d = rows[r]
            dx, dy = d[0] - px, d[1] - py
            sigma = 0.5 * (d[2] * dx * dx + d[4] * dy * dy) + d[3] * dx * dy
            alpha = (d[5] * torch.exp(-sigma.clamp(0.0, 60.0))).clamp(
                max=gc.ALPHA_CLIP)
            keep = (sigma >= 0) & (alpha >= gc.ALPHA_MIN)
            acc = acc + torch.where(keep, alpha * T, 0.0) * d[8:, None]
            T = torch.where(keep, T * (1.0 - alpha), T)
        accs.append(acc)
        Ts.append(T[None])
    to_image = (lambda x: gc._tiles_to_image(
        torch.stack(x), ntx, kw["nty"], ts, kw["img_h"], kw["img_w"])[0])
    return to_image(accs), to_image(Ts)[0]


@pytest.mark.parametrize("ts", [8, 12])
def test_compositor_plain_gradients(ts):
    """Autograd through the plain forward (what chip_smoke.py holds the
    compositor backward against) gives the pair rows' gradients of a
    brute-force per-pixel forward, to float32 rounding."""
    rows, starts, ends, kw = _frame(ts)
    rng = np.random.RandomState(1)
    d_img = torch.from_numpy(rng.randn(C, kw["img_h"], kw["img_w"]).astype(
        np.float32))
    d_T = torch.from_numpy(rng.randn(kw["img_h"], kw["img_w"]).astype(
        np.float32))
    grads, cnt = [], None
    for forward in ("plain", "brute force"):
        leaf = rows.clone().requires_grad_(True)
        if forward == "plain":
            img, T, cnt = gc.compositor_fwd_plain(leaf, starts, ends, **kw)
        else:
            img, T = _brute_force_forward(leaf, starts, ends, cnt, kw)
        (g,) = torch.autograd.grad((img * d_img).sum() + (T * d_T).sum(),
                                   leaf)
        grads.append(g)
    got, ref = grads
    assert float(ref[:, :6].abs().sum()) > 0 and float(ref[:, 8:].abs().sum())
    assert torch.allclose(got, ref, rtol=1e-4,
                          atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("n_imgs", [1, 2])
@pytest.mark.parametrize("ts", [8, 12, 16])
def test_saturated_warp_skip_is_exact(ts, n_imgs):
    """Masking the saturated warps' pixels out of the rows they skip leaves
    color, T and cnt equal bit for bit: in both windows, and in P1's
    variants (replaying cnt), with the image axis of the fold."""
    rows, starts, ends, kw = _frame(ts, n_imgs)
    windows = ["pallas"] if n_imgs > 1 else ["pallas", "xla"]
    cnt = None
    for window in windows:
        counts = {}
        ref = gc.compositor_fwd_plain(rows, starts, ends, window=window,
                                      **kw)
        got = gc.compositor_fwd_plain(rows, starts, ends, window=window,
                                      counts=counts, skip_saturated=True,
                                      **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), window
        assert counts["skipped_visits"] > 0 or (ts == 8
                                                and window == "pallas")
        cnt = ref[2] if window == "pallas" else cnt
    for variant in ("full", "noexp", "nochain", "loadonly"):
        args = dict(variant=variant, replay_cnt=cnt, **kw)
        counts = {}
        ref = gc.compositor_fwd_plain(rows, starts, ends, **args)
        got = gc.compositor_fwd_plain(rows, starts, ends, counts=counts,
                                      skip_saturated=True, **args)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), variant
        # loadonly adds raw colours whatever T is: nothing to skip
        if variant == "loadonly":
            assert counts["skipped_visits"] == 0


def test_k1_outputs_compare():
    """k1_outputs: equal outputs pass; a colour one ulp off passes (K1's
    tolerance), one 1e-3 off fails; T or cnt off in one element fails."""
    from goliath_torch.scripts import k1_outputs

    g = torch.Generator().manual_seed(0)
    ref = (torch.rand(4, 6, 5, generator=g), torch.rand(6, 5, generator=g),
           torch.arange(3, dtype=torch.int32))
    same = k1_outputs.compare_outputs
    assert same("K1", ref, tuple(t.clone() for t in ref))
    up = torch.tensor(2.0)
    color = ref[0].clone()
    color[0, 0, 0] = torch.nextafter(color[0, 0, 0], up)
    assert same("K1", ref, (color, ref[1], ref[2]))
    color[1, 2, 3] += 1e-3
    assert not same("K1", ref, (color, ref[1], ref[2]))
    T = ref[1].clone()
    T[2, 2] = torch.nextafter(T[2, 2], up)
    assert not same("K1", ref, (ref[0], T, ref[2]))
    assert not same("K1", ref, (ref[0], ref[1], ref[2] + (ref[2] == 1)))


def test_chip_smoke_zero_rows_below_float32_normals():
    """chip_smoke's pair-gradient comparison: a row exactly zero in the
    plain version and nonzero in the other only by float32 denormals fails
    the exact zero-row check and passes with K6_ZERO_BELOW (the later fold
    steps); a row nonzero above float32's smallest normal fails both; rows
    nonzero in both are held by the tolerance alone, however small."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.K6_ZERO_BELOW == torch.finfo(torch.float32).tiny
    g = torch.Generator().manual_seed(1)
    ref = torch.randn(200, 16, generator=g)
    ref[:, 6 + C:] = 0
    ref[150:] = 0
    assert cs.compare_pair_grads(gc, torch, ref.clone(), ref, C, "K6") == 0
    # a row with a gradient in both whose largest entry is a normal number
    # in one and a denormal in the other is held by the tolerance alone
    ref[20, :6 + C] = 2e-38
    for value, held in ((1e-44, True), (1e-30, False)):
        got = ref.clone()
        got[20, :6 + C] = 1e-38
        got[160, 3] = value
        with pytest.raises(AssertionError):
            cs.compare_pair_grads(gc, torch, got, ref, C, "K6")
        if held:
            cs.compare_pair_grads(gc, torch, got, ref, C, "K6",
                                  cs.K6_ZERO_BELOW)
        else:
            with pytest.raises(AssertionError):
                cs.compare_pair_grads(gc, torch, got, ref, C, "K6",
                                      cs.K6_ZERO_BELOW)
