"""K5's per-warp cull (ops/rasterizer_cuda.py ``k5_may_hit``, the float32
mirror of csrc/zbuffer.cu's test, operation for operation) on the CPU.

The cull is exact only if it never skips a (row, pixel) pair that the
kernel's own arithmetic (``k5_hits``, the plain version's) counts as a hit.
Each scene below is binned as the kernel's caller bins it
(``rasterizer.bin_faces``), every (row, pixel) pair of every tile's window
is evaluated, and no hit may fall in a (row, warp) pair the mirror culls.
Scenes: random meshes, the sphere fixture of tests/test_torch_rasterizer.py
(its pole faces are degenerate), slivers, faces whose edges run along the
warp regions' borders and through pixel centres, and screen coordinates up
to 2048. The cull must also skip most rows whose face's screen box misses
the warp's region, and the plain version's counts of the kernel's work
must add up. No tolerance: all exact.
"""

import numpy as np
import pytest
import torch

from goliath_torch.data.synthetic import make_camera_ring, make_sphere_mesh
from goliath_torch.ops import rasterizer as tr
from goliath_torch.ops import rasterizer_cuda as rc

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)


def _triangles(corners, z):
    """v_pix [3F, 3] and vi [F, 3] of F separate faces, corners [F, 3, 2]
    and per-corner depths [F, 3]."""
    corners = np.asarray(corners, np.float32)
    z = np.broadcast_to(np.asarray(z, np.float32), corners.shape[:2])
    v = np.concatenate([corners, z[..., None]], -1).reshape(-1, 3)
    vi = np.arange(len(v), dtype=np.int64).reshape(-1, 3)
    return torch.from_numpy(v.copy()), torch.from_numpy(vi)


def _random_mesh(seed, n, H, W, size):
    rng = np.random.default_rng(seed)
    centre = rng.uniform([0, 0], [W, H], (n, 1, 2))
    scale = rng.exponential(size, (n, 1, 1))
    corners = centre + scale * rng.normal(size=(n, 3, 2))
    return _triangles(corners, rng.uniform(1.0, 10.0, (n, 3)))


def _sphere(n_lat, n_lon, H, W):
    v, vi, _vt, _vti = make_sphere_mesh(n_lat, n_lon, radius=100.0)
    K, Rt, _ = make_camera_ring(1, H, W)
    v_pix = tr.transform(torch.from_numpy(v[None]), torch.from_numpy(K),
                         torch.from_numpy(Rt))[0]
    return v_pix, torch.from_numpy(vi)


def _slivers(seed, n, H, W):
    """Long faces of near-zero width: the third corner 0 to 0.5 px off
    the segment between the other two."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform([0, 0], [W, H], (n, 2))
    p1 = p0 + rng.uniform(-60, 60, (n, 2))
    t = rng.uniform(0.2, 0.8, (n, 1))
    normal = (p1 - p0)[:, ::-1] * np.array([1, -1])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    width = rng.choice([0.0, 1e-4, 1e-3, 0.05, 0.5], (n, 1))
    p2 = p0 + t * (p1 - p0) + width * normal
    return _triangles(np.stack([p0, p1, p2], 1), rng.uniform(1, 5, (n, 3)))


def _border_faces(H, W, x_far, y_far):
    """Faces whose edges run along the borders of the 8x4 warp regions
    (x a multiple of 8, y of 4) and through rows and columns of pixel
    centres (x or y + 0.5), near the origin and near (x_far, y_far)."""
    faces = []
    for ox, oy in ((16, 12), (x_far, y_far)):
        for dx, dy in ((0.0, 0.0), (0.5, 0.5), (8.0, 4.5), (7.5, 3.0)):
            x, y = ox + dx, oy + dy
            for w in (3.0, 8.0, 13.5):
                faces += [[(x, y), (x, y + 24), (x + w, y + 12)],
                          [(x, y), (x, y + 24), (x - w, y + 12)],
                          [(x, y), (x + 24, y), (x + 12, y + w)],
                          [(x, y), (x + 24, y), (x + 12, y - w)],
                          [(x, y), (x + w, y), (x, y + w)],
                          [(x + w, y + w), (x + w, y), (x, y + w)]]
    return _triangles(faces, 2.0)


def _window_pairs(b, chunk, mfpt):
    """(tile, row) of every pair in the kernel's windows."""
    start = b.tile_start.long()
    end = b.tile_end.long()
    nchunks = mfpt // chunk + 1
    win_end = torch.minimum(end, (start // chunk + nchunks) * chunk)
    n = (win_end - start).clamp(min=0)
    tile = torch.repeat_interleave(torch.arange(len(n)), n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    return tile, start[tile] + torch.arange(len(tile)) - first


def _pixel_warps(ts):
    pixel_map = rc.k5_pixel_map(ts)
    live = pixel_map >= 0
    owner = torch.empty(ts * ts, dtype=torch.long)
    owner[pixel_map[live]] = torch.arange(len(pixel_map))[:, None].expand_as(
        pixel_map)[live]
    return owner


def _check_cull(v_pix, vi, H, W, ts, chunk=32, mfpt=256):
    """Hold the cull against every (row, pixel) pair of the windows; return
    (pairs hit, (row, warp) pairs culled, pairs whose face's screen box
    misses the warp's region, those of them culled)."""
    rows, b = tr.bin_faces(v_pix, vi, H, W, ts)
    tile, r = _window_pairs(b, chunk, mfpt)
    ntx = b.num_tiles_x
    d = rows[r]
    tx0, ty0 = (tile % ntx) * ts, (tile // ntx) * ts
    may = rc.k5_may_hit(d, tx0, ty0, ts)                       # [N, W]
    pix = torch.arange(ts * ts)
    px = (tx0[:, None] + pix % ts).float() + 0.5
    py = (ty0[:, None] + pix // ts).float() + 0.5
    hit, _ = rc.k5_hits(d[:, None], px, py)                    # [N, P]
    wrong = hit & ~may[:, _pixel_warps(ts)]
    assert not bool(wrong.any()), (
        f"{int(wrong.sum())} hits culled, rows "
        f"{r[wrong.any(1)][:5].tolist()}")
    # the faces' screen boxes against the warps' regions (pixel centres)
    corners = v_pix[vi[b.sorted_prim[r].long()]][..., :2]       # [N, 3, 2]
    lo, hi = corners.amin(1), corners.amax(1)
    reg = rc.k5_regions(ts)
    rx0 = tx0[:, None] + reg[:, 0] + 0.5
    rx1 = tx0[:, None] + reg[:, 1] + 0.5
    ry0 = ty0[:, None] + reg[:, 2] + 0.5
    ry1 = ty0[:, None] + reg[:, 3] + 0.5
    outside = ((rx1 < lo[:, None, 0] - 1) | (rx0 > hi[:, None, 0] + 1)
               | (ry1 < lo[:, None, 1] - 1) | (ry0 > hi[:, None, 1] + 1))
    outside = outside & (d[:, 9:10] != 0)
    return (int(hit.sum()), int((~may).sum()), int(outside.sum()),
            int((outside & ~may).sum()))


@pytest.mark.parametrize("ts", [8, 12, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_cull_keeps_every_hit_on_random_meshes(seed, ts):
    H, W = 72, 100
    v_pix, vi = _random_mesh(seed, 150, H, W, 6.0)
    n_hit, n_culled, n_out, n_out_culled = _check_cull(v_pix, vi, H, W, ts)
    assert n_hit > 1000 and n_culled > 0
    assert n_out_culled >= 0.75 * n_out


@pytest.mark.parametrize("n_lat,n_lon,H,W", [(6, 8, 48, 64),
                                             (16, 32, 72, 100)])
@pytest.mark.parametrize("ts", [8, 16])
def test_cull_keeps_every_hit_on_the_sphere(n_lat, n_lon, H, W, ts):
    """The sphere fixture's pole fans hold faces with two equal corners
    (area 0, |inv_area| * valid = 0): culled, and never a hit."""
    v_pix, vi = _sphere(n_lat, n_lon, H, W)
    n_hit, n_culled, n_out, n_out_culled = _check_cull(v_pix, vi, H, W, ts)
    assert n_hit > 500 and n_culled > 0
    assert n_out_culled >= 0.75 * n_out


@pytest.mark.parametrize("ts", [8, 16, 24])
def test_cull_keeps_every_hit_on_slivers(ts):
    H, W = 72, 100
    v_pix, vi = _slivers(3, 200, H, W)
    n_hit, n_culled, _, _ = _check_cull(v_pix, vi, H, W, ts)
    assert n_hit > 100 and n_culled > 0


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_cull_keeps_every_hit_along_region_borders(ts):
    """Edges on the regions' borders and through pixel centres (E = 0
    exactly at a row or column of centres, a hit), near the origin and at
    screen coordinates near 2048."""
    H, W = 1334, 2048
    v_pix, vi = _border_faces(H, W, 2000.0, 1280.0)
    n_hit, n_culled, _, _ = _check_cull(v_pix, vi, H, W, ts)
    assert n_hit > 1000 and n_culled > 0


@pytest.mark.parametrize("ts", [16, 32])
def test_cull_keeps_every_hit_at_full_screen_coordinates(ts):
    """Faces spread over a 2048x1334 screen: the rounding of the edge
    functions grows with the coordinates."""
    H, W = 1334, 2048
    v_pix, vi = _random_mesh(5, 120, H, W, 10.0)
    slivers, s_vi = _slivers(6, 60, H, W)
    v_pix = torch.cat([v_pix, slivers])
    vi = torch.cat([vi, s_vi + len(v_pix) - len(slivers)])
    n_hit, n_culled, n_out, n_out_culled = _check_cull(v_pix, vi, H, W, ts)
    assert n_hit > 1000 and n_culled > 0
    assert n_out_culled >= 0.75 * n_out


@pytest.mark.parametrize("mfpt,chunk,ts", [(256, 32, 16), (16, 8, 16),
                                           (64, 32, 32), (64, 32, 8),
                                           (64, 16, 12)])
def test_plain_version_counts_the_cull(mfpt, chunk, ts):
    """zbuffer_plain's counts of the kernel's work add up, leave the outputs
    as they are, and the cull leaves fewer evaluations than the first
    design's."""
    H, W = 72, 100
    v_pix, vi = _sphere(16, 32, H, W)
    rows, b = tr.bin_faces(v_pix, vi, H, W, ts)
    args = (rows, b.sorted_prim, b.tile_start, b.tile_end, H, W, ts,
            b.num_tiles_x, b.num_tiles_y, chunk, mfpt)
    idx, z = rc.zbuffer_plain(*args)
    counts = {}
    c_idx, c_z = rc.zbuffer_plain(*args, counts=counts)
    assert torch.equal(idx, c_idx)
    assert torch.equal(z.view(torch.int32), c_z.view(torch.int32))
    assert float((idx >= 0).float().mean()) > 0.1
    n_warps = len(rc.k5_pixel_map(ts))
    assert (counts["warp_visits"] + counts["culled_visits"]) * ts * ts == \
        counts["design_evals"] * n_warps
    assert 0 < counts["evals"] < counts["design_evals"]
    if ts % 8 == 0:
        assert counts["evals"] == 32 * counts["warp_visits"]
