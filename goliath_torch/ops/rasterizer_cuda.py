"""The mesh z-buffer K5, its plain version and its wrapper (counterpart of
the JAX package's ops/rasterizer_pallas.py).

K5 ``zbuffer`` (``csrc/zbuffer.cu``, built into the extension of
``ops/gsplat_cuda.py``) replaces ``_zbuffer_kernel`` /
``rasterize_zbuffer_pallas``: per pixel, the nearest of the tile's binned
faces, ties to the lowest sorted-pair index. Plain version:
``zbuffer_plain``, the same float32 operations in PyTorch over the Pallas
kernel's chunk-aligned window. Both follow that window, not the JAX XLA
scan's (``rasterize`` with ``use_pallas=False`` covers
``[start, start + max_faces_per_tile)`` and has no ``izp > 0`` test); the
two differ only in tiles that overflow ``max_faces_per_tile``.

K5 skips, per warp, the rows that cannot hit any pixel of the warp's
region (``k5_pixel_map``, ``k5_regions``): ``k5_may_hit`` mirrors that cull
test operation for operation in float32, so ``zbuffer_plain(...,
counts=)`` gives the kernel's evaluations (tests/test_torch_zbuffer_cull.py
holds that the cull never skips a hit).

The wrapper takes the kernel for a CUDA tensor and the plain version for a
CPU tensor (ops/backend.py), and adds one to
``gsplat_cuda.LAUNCHES["zbuffer"]`` (``gsplat_cuda.count_launch``) each
time it launches the kernel. The
op returns indices and takes no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from goliath_torch.ops import gsplat_cuda
from goliath_torch.ops.backend import target_backend

BIG_DEPTH = 3.0e38
ROW_COLS = 16  # a(3) b(3) c(3) |inv_area|*valid iz(3), 3 pad
# K5's cull margin (csrc/zbuffer.cu): relative, absolute, and the largest
# margin at which a row may be culled
CULL_REL, CULL_ABS, CULL_MAX = 2.0 ** -20, 2.0 ** -100, 2.0 ** 100


def pack_face_rows(an, bn, cn, inv_area_abs, inv_z, valid,
                   sorted_prim) -> torch.Tensor:
    """Face rows [budget, 16] f32 in sorted-pair order
    (rasterizer_pallas.py:119-125). ``valid`` (float, 0 or 1) scales
    |inv_area|, so an invalid face gives izp = 0 and never wins."""
    Fn = an.shape[0]
    gi = sorted_prim.clamp(0, Fn - 1).long()
    src = torch.cat([an, bn, cn, (inv_area_abs * valid)[:, None], inv_z],
                    dim=1)
    return F.pad(src[gi], (0, ROW_COLS - src.shape[1]))


def k5_pixel_map(tile_size: int) -> torch.Tensor:
    """Pixel of each (warp, lane) of K5's threads, as a row-major index into
    the tile or -1 for none ([warps, 32] int64; csrc/zbuffer.cu): where the
    tile size is a multiple of 8, a warp owns an 8x4 region and lane l
    takes column l % 8 and row l // 8 of it; otherwise the threads take the
    pixels in row order, those past the tile owning none."""
    ts = tile_size
    P = ts * ts
    if ts % 8 == 0:
        warp = torch.arange(P // 32)[:, None]
        lane = torch.arange(32)[None]
        x = (warp % (ts // 8)) * 8 + lane % 8
        y = (warp // (ts // 8)) * 4 + lane // 8
        return y * ts + x
    pix = torch.arange(-(-P // 32) * 32).reshape(-1, 32)
    return torch.where(pix < P, pix, -1)


def k5_regions(tile_size: int) -> torch.Tensor:
    """Each warp's region in the tile, the bounding box of its pixels:
    [warps, 4] int64 (x0, x1, y0, y1), inclusive."""
    m = k5_pixel_map(tile_size)
    live = m >= 0
    x, y = m % tile_size, m // tile_size
    return torch.stack([torch.where(live, x, tile_size).amin(1),
                        torch.where(live, x, -1).amax(1),
                        torch.where(live, y, tile_size).amin(1),
                        torch.where(live, y, -1).amax(1)], 1)


def k5_may_hit(d: torch.Tensor, tx0: torch.Tensor, ty0: torch.Tensor,
               tile_size: int) -> torch.Tensor:
    """K5's cull test, operation for operation in float32 (each product and
    sum rounded on its own, in the kernel's order): may row ``d`` hit a
    pixel of each warp's region? d: [..., 16] face rows; tx0, ty0: integer
    pixel origins of the rows' tiles, broadcastable to d's leading shape.
    Returns bool [..., warps]; False only where every pixel of the region
    fails an edge test in the kernel's arithmetic (csrc/zbuffer.cu derives
    the margin)."""
    reg = k5_regions(tile_size).to(d.device)
    rx0, rx1, ry0, ry1 = reg.unbind(1)                       # [W]
    ox, oy = tx0.long()[..., None], ty0.long()[..., None]    # [..., 1]
    xc = (2 * ox + rx0 + rx1 + 1).float() * 0.5              # [..., W]
    yc = (2 * oy + ry0 + ry1 + 1).float() * 0.5
    hx = (rx1 - rx0).float() * 0.5                           # [W]
    hy = (ry1 - ry0).float() * 0.5
    X = (ox + rx1).float() + 0.5
    Y = (oy + ry1).float() + 0.5
    rel, eps, top = (torch.tensor(v, dtype=torch.float32, device=d.device)
                     for v in (CULL_REL, CULL_ABS, CULL_MAX))
    skip = d[..., 9, None] == 0.0
    for k in range(3):
        a, b, c = (d[..., j + k, None] for j in (0, 3, 6))
        aa, ab = a.abs(), b.abs()
        s = (((a * xc + b * yc) + c) + aa * hx) + ab * hy
        m = ((aa * X + ab * Y) + c.abs()) * rel + eps
        skip = skip | ((m < top) & (s < -m))
    return ~skip


def k5_hits(d: torch.Tensor, px: torch.Tensor, py: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's per (row, pixel) arithmetic: d [..., 16] face rows, px, py
    pixel centres broadcastable to d's leading shape. Returns (hit, depth,
    BIG_DEPTH where it misses)."""
    e0 = d[..., 0] * px + d[..., 3] * py + d[..., 6]
    e1 = d[..., 1] * px + d[..., 4] * py + d[..., 7]
    e2 = d[..., 2] * px + d[..., 5] * py + d[..., 8]
    izp = (e0 * d[..., 10] + e1 * d[..., 11] + e2 * d[..., 12]) * d[..., 9]
    hit = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (izp > 0.0)
    return hit, torch.where(hit, 1.0 / izp.clamp(min=1e-12), BIG_DEPTH)


def zbuffer_plain(rows, sorted_prim, tile_start, tile_end, img_h: int,
                  img_w: int, tile_size: int, ntx: int, nty: int, chunk: int,
                  max_faces_per_tile: int, counts: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5. Block j of tile t covers rows
    [(start//chunk + j)*chunk, +chunk) masked to [start, end), for
    j < max_faces_per_tile//chunk + 1; within a block the first row of the
    smallest depth wins (``argmin`` returns the first), across blocks a
    strictly smaller depth. Tiles run in batches to bound the
    [tiles, chunk, pixels] temporaries to ``gsplat_cuda.PLAIN_BATCH_ELEMS``
    elements.

    ``counts``, if given, receives K5's work (ints): "design_evals", the
    (row, pixel) evaluations of every pixel of the tile for every row of
    the window (the first design's); "warp_visits" and "culled_visits", the
    (row, warp) pairs the kernel's cull (``k5_may_hit``) keeps and skips;
    "evals", the (row, pixel) evaluations it makes. Returns (face index [H, W] int32, -1 where empty; depth [H, W], BIG
    there)."""
    P = tile_size * tile_size
    n_tiles = ntx * nty
    nchunks = max_faces_per_tile // chunk + 1
    tile_batch = max(1, gsplat_cuda.PLAIN_BATCH_ELEMS // (chunk * P))
    dev = rows.device
    pix = torch.arange(P, device=dev)
    lane = torch.arange(chunk, device=dev)
    last_row = max(rows.shape[0] - 1, 0)
    if counts is not None:
        live = (k5_pixel_map(tile_size) >= 0).sum(1).to(dev)  # [W]
        work = torch.zeros(4, dtype=torch.long, device=dev)
    zs, ss = [], []
    for t0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        start = tile_start[tiles].long()
        end = tile_end[tiles].long()
        tx0, ty0 = (tiles % ntx) * tile_size, (tiles // ntx) * tile_size
        # the kernel's pixel centres: integer coordinate to float, + 0.5
        px = (tx0[:, None] + pix % tile_size).float() + 0.5   # [n, P]
        py = (ty0[:, None] + pix // tile_size).float() + 0.5
        best_z = torch.full((len(tiles), P), BIG_DEPTH, device=dev)
        best_s = torch.full((len(tiles), P), -1, dtype=torch.long,
                            device=dev)
        for j in range(nchunks):
            base = (start // chunk + j) * chunk
            idx = base[:, None] + lane                       # [n, CH]
            m = (idx >= start[:, None]) & (idx < end[:, None])
            if not bool(m.any()):
                continue
            d = rows[idx.clamp(max=last_row)]               # [n, CH, 16]
            hit, zp = k5_hits(d[:, :, None], px[:, None], py[:, None])
            hit = hit & m[..., None]                         # [n, CH, P]
            if counts is not None:
                may = k5_may_hit(d, tx0[:, None], ty0[:, None],
                                 tile_size) & m[..., None]   # [n, CH, W]
                n_may = may.sum()
                work += torch.stack([m.sum() * P, n_may,
                                     m.sum() * len(live) - n_may,
                                     (may * live).sum()])
            zp = torch.where(hit, zp, BIG_DEPTH)
            zmin, k = zp.min(dim=1)                           # first of ties
            upd = zmin < best_z
            best_z = torch.where(upd, zmin, best_z)
            best_s = torch.where(upd, base[:, None] + k, best_s)
        zs.append(best_z)
        ss.append(best_s)
    if counts is not None:
        counts.update(zip(("design_evals", "warp_visits", "culled_visits",
                           "evals"), work.tolist()))
    best_z, best_s = torch.cat(zs), torch.cat(ss)
    hit = (best_z < BIG_DEPTH) & (best_s >= 0)
    face = sorted_prim[best_s.clamp(0, last_row)].long()
    index = torch.where(hit, face, -1).to(torch.int32)

    def untile(x):
        x = x.reshape(nty, ntx, tile_size, tile_size).permute(0, 2, 1, 3)
        return x.reshape(nty * tile_size, ntx * tile_size)[:img_h, :img_w]

    return untile(index).contiguous(), untile(best_z).contiguous()


def zbuffer(rows, sorted_prim, tile_start, tile_end, img_h: int, img_w: int,
            tile_size: int, ntx: int, nty: int, chunk: int,
            max_faces_per_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors, ``zbuffer_plain`` on CPU tensors.

    rows: [R, 16] f32 from ``pack_face_rows``; sorted_prim [R] int32;
    tile_start/tile_end: [ntx * nty] int32 with 0 <= start <= end <= R
    (``bin_to_tiles`` guarantees this). Returns (face index [H, W] int32,
    -1 where empty; depth [H, W] f32, ``BIG_DEPTH`` there)."""
    n_tiles = ntx * nty
    if rows.dim() != 2 or rows.shape[1] != ROW_COLS \
            or rows.dtype != torch.float32:
        raise ValueError(f"rows must be [R, {ROW_COLS}] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if sorted_prim.shape != (rows.shape[0],) \
            or sorted_prim.dtype != torch.int32:
        raise ValueError(f"sorted_prim must be [{rows.shape[0]}] int32, got "
                         f"{tuple(sorted_prim.shape)} {sorted_prim.dtype}")
    for t in (tile_start, tile_end):
        if t.shape != (n_tiles,) or t.dtype != torch.int32:
            raise ValueError(f"tile bounds must be [{n_tiles}] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if target_backend(rows) == "cpu":
        return zbuffer_plain(rows, sorted_prim, tile_start, tile_end, img_h,
                             img_w, tile_size, ntx, nty, chunk,
                             max_faces_per_tile)
    if tile_size * tile_size > 1024:
        raise ValueError(f"K5 takes tiles of at most 32x32, got {tile_size}")
    index_img, z_img = gsplat_cuda.load_kernels().zbuffer(
        rows.contiguous(), sorted_prim.contiguous(), tile_start.contiguous(),
        tile_end.contiguous(), ntx, tile_size, img_h, img_w, chunk,
        max_faces_per_tile // chunk + 1)
    gsplat_cuda.count_launch("zbuffer", rows)
    return index_img, z_img
