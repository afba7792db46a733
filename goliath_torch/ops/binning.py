"""Screen-tile and 3-D cell binning (port of the JAX package's
ops/binning.py).

Primitives' tile AABBs expand into (tile, prim) pairs in a fixed-size pair
buffer; ONE stable sort on the int32 composite key ``tile << shift | qdepth``
groups the pairs per tile in depth order; ``searchsorted`` gives each tile's
[start, end) segment. Static budgets (max tiles per primitive, pair budget)
replace dynamic allocation; overflow drops the farthest primitives.

The two prefix sums (per-prim pair ends and slot owners) run as kernel K4
on CUDA tensors (``gsplat_cuda.cumsum1d``). The MVP march bins its prims'
projected boxes here too (``ops/mvp.py``). ``bin_boxes_to_cells`` is the
3-D analogue that the OLAT teacher's deep-shadow density grid bins its
prims' cell boxes with (``ops/mvp.splat_density_grid``); its prefix sum is
a plain ``torch.cumsum``, as the JAX package's is ``jnp.cumsum``, so it
launches no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from goliath_torch.ops.gsplat_cuda import cumsum1d


class TileBinning(NamedTuple):
    sorted_prim: torch.Tensor   # [budget] prim index per pair (depth order/tile)
    tile_start: torch.Tensor    # [num_tiles]
    tile_end: torch.Tensor      # [num_tiles]
    perm: torch.Tensor          # [budget] sorted position -> pre-sort slot
    prim_offsets: torch.Tensor  # [N] first pre-sort slot of each prim
    prim_ends: torch.Tensor     # [N] one-past-last pre-sort slot of each prim
    tile_of_pair: torch.Tensor  # [budget] owning tile per sorted pair
                                # (== num_tiles for unused slots)
    num_tiles_x: int
    num_tiles_y: int


def clip_spans(tile_min: torch.Tensor, tile_max: torch.Tensor, ntx: int,
               nty: int, K: int):
    """Each primitive's tile rect clipped to the ``ntx`` x ``nty`` grid,
    and, where its area exceeds ``K`` tiles, center-cropped to fit while
    keeping its aspect: (x0, y0, w, h), int32 [N] each."""
    x0 = tile_min[:, 0].clamp(0, ntx)
    y0 = tile_min[:, 1].clamp(0, nty)
    x1 = tile_max[:, 0].clamp(0, ntx)
    y1 = tile_max[:, 1].clamp(0, nty)

    w = (x1 - x0).clamp(min=0)
    h = (y1 - y0).clamp(min=0)
    # center-crop spans whose AREA exceeds the per-prim budget, preserving
    # aspect: w' = w*sqrt(K/area) rounded down, h' = min(h, K // w')
    area = w * h
    over = area > K
    ratio = torch.sqrt(K / area.float().clamp(min=1.0))
    w_c = (w.float() * ratio).to(torch.int32).clamp(1, K)
    w_new = torch.where(over, torch.minimum(w_c, w), w)
    h_new = torch.minimum(h, K // w_new.clamp(min=1))
    cx = (x0 + x1) // 2
    cy = (y0 + y1) // 2
    x0 = torch.where(w_new < w, (cx - w_new // 2).clamp(0, ntx), x0)
    y0 = torch.where(h_new < h, (cy - h_new // 2).clamp(0, nty), y0)
    w, h = w_new, h_new
    return x0, y0, w, h


def bin_to_tiles(
    tile_min: torch.Tensor,   # [N, 2] inclusive tile coords (x, y), int32
    tile_max: torch.Tensor,   # [N, 2] exclusive tile coords (x, y), int32
    valid: torch.Tensor,      # [N] bool
    num_tiles_x: int,
    num_tiles_y: int,
    max_tiles_per_prim: int = 64,
    pair_budget: int | None = None,
    depth_keys: torch.Tensor | None = None,   # [N] int32 quantized depth
) -> TileBinning:
    """Bin primitive AABBs into per-tile depth-ordered pair lists.

    With ``depth_keys=None`` primitives must come sorted by depth; otherwise
    the sort key carries the quantized depth (ties break by slot, i.e. by
    primitive index). Spans over ``max_tiles_per_prim`` tiles are
    center-cropped area-proportionally to fit.
    """
    N = tile_min.shape[0]
    dev = tile_min.device
    if pair_budget is None:
        pair_budget = 4 * N
    num_tiles = num_tiles_x * num_tiles_y
    K = max_tiles_per_prim

    x0, y0, w, h = clip_spans(tile_min, tile_max, num_tiles_x, num_tiles_y,
                              K)

    counts = torch.where(valid, w * h, 0).to(torch.int32)   # [N]
    ends = cumsum1d(counts)                                  # inclusive (K4)
    offsets = ends - counts                                  # exclusive

    # slot s belongs to the prim whose [offset, end) holds it:
    # prim_of_slot[s] = #{i : ends[i] <= s}, a bincount of the ends plus an
    # inclusive prefix sum (K4) over the slots
    marks = torch.zeros(pair_budget, dtype=torch.int32, device=dev)
    marks.index_add_(0, ends.clamp(0, pair_budget - 1).long(),
                     (ends < pair_budget).to(torch.int32))
    prim_of_slot = cumsum1d(marks)   # [budget]; == N for slots past the end
    in_range = prim_of_slot < N
    p = prim_of_slot.clamp(0, N - 1).long()
    if depth_keys is None:
        shift = 0
        qd = torch.zeros_like(offsets)
    else:
        shift = 31 - int(num_tiles + 1).bit_length()
        if shift < 12:
            raise ValueError(
                f"too many tiles ({num_tiles}) for a composite int32 sort "
                "key with a useful depth resolution")
        qd = depth_keys.clamp(0, (1 << shift) - 1).to(torch.int32)

    slots = torch.arange(pair_budget, dtype=torch.int32, device=dev)
    k = slots - offsets[p]
    wk = w.clamp(min=1)[p]
    # integer division is exact; the JAX float-division form
    # (binning.py:151-157) was a TPU workaround giving the same values
    kd = k // wk
    tx = x0[p] + (k - kd * wk)
    ty = y0[p] + kd
    tile_of_slot = (ty * num_tiles_x + tx).to(torch.int32)
    keys = torch.where(in_range, (tile_of_slot << shift) | qd[p],
                       num_tiles << shift).to(torch.int32)
    vals = torch.where(in_range, p, 0).to(torch.int32)

    # the stable sort keeps slot (hence prim) order inside equal keys; its
    # index output is the slot payload
    keys_sorted, perm = torch.sort(keys, stable=True)
    perm = perm.to(torch.int32)
    vals_sorted = vals[perm.long()]

    # tile_end[t] == tile_start[t+1]: ONE searchsorted gives both bounds
    # (unused slots carry the sentinel key num_tiles << shift)
    tile_ids = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) << shift
    bounds = torch.searchsorted(keys_sorted, tile_ids, side="left",
                                out_int32=True)
    tile_start = bounds[:-1]
    tile_end = bounds[1:]
    tile_of_pair = (keys_sorted >> shift) if shift else keys_sorted
    offsets_c = offsets.clamp(max=pair_budget)
    ends_c = ends.clamp(max=pair_budget)
    return TileBinning(vals_sorted, tile_start, tile_end, perm,
                       offsets_c.to(torch.int32), ends_c.to(torch.int32),
                       tile_of_pair, num_tiles_x, num_tiles_y)


class CellBinning(NamedTuple):
    sorted_prim: torch.Tensor   # [budget] prim index per (cell, prim) pair
    cell_start: torch.Tensor    # [num_cells]
    cell_end: torch.Tensor      # [num_cells]


def cell_spans(cell_min: torch.Tensor, cell_max: torch.Tensor,
               ncells: Tuple[int, int, int], max_cells_per_prim: int):
    """Each primitive's cell box clipped to the grid and, along each axis
    whose span exceeds kspan = round(cbrt(max_cells_per_prim)),
    center-cropped to kspan: (lo [N, 3], span [N, 3])."""
    kspan = max(int(round(max_cells_per_prim ** (1.0 / 3.0))), 1)
    lim = torch.tensor(ncells, dtype=cell_min.dtype, device=cell_min.device)
    lo = torch.minimum(cell_min.clamp(min=0), lim)
    hi = torch.minimum(cell_max.clamp(min=0), lim)
    span = (hi - lo).clamp(min=0)
    center = (lo + hi) // 2
    lo = torch.where(span > kspan,
                     torch.minimum((center - kspan // 2).clamp(min=0), lim),
                     lo)
    return lo, span.clamp(max=kspan)


def bin_boxes_to_cells(
    cell_min: torch.Tensor,   # [N, 3] inclusive cell coords (x, y, z), int32
    cell_max: torch.Tensor,   # [N, 3] exclusive
    valid: torch.Tensor,      # [N] bool
    ncells: Tuple[int, int, int],   # (ncx, ncy, ncz)
    max_cells_per_prim: int = 64,
    pair_budget: Optional[int] = None,
) -> CellBinning:
    """Expand each primitive's cell box into (cell, prim) pairs in a
    ``pair_budget`` buffer (8 N when None) and group them per cell, prims
    in index order (the JAX package's ``bin_boxes_to_cells``). Spans over
    kspan = round(cbrt(max_cells_per_prim)) cells an axis are
    center-cropped to kspan; slots past the budget are lost."""
    N = cell_min.shape[0]
    dev = cell_min.device
    ncx, ncy, ncz = ncells
    if pair_budget is None:
        pair_budget = 8 * N
    num_cells = ncx * ncy * ncz
    lo, span = cell_spans(cell_min, cell_max, ncells, max_cells_per_prim)
    w, h, d = span.unbind(1)

    counts = torch.where(valid, w * h * d, 0)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    offsets = ends - counts

    slots = torch.arange(pair_budget, dtype=torch.int32, device=dev)
    prim_of_slot = torch.searchsorted(ends, slots, right=True)
    in_range = prim_of_slot < N
    p = prim_of_slot.clamp(0, N - 1)
    k = slots - offsets[p]
    wk = w.clamp(min=1)[p]
    hk = h.clamp(min=1)[p]
    # the JAX package's float division in place of integer div/mod: k <
    # kspan^3 <= max_cells_per_prim and wk, hk <= kspan keep it exact, and
    # the port takes the same steps so that it gives the same cells
    kf = k.float()
    wf = wk.float()
    kw = torch.floor(kf / wf).to(torch.int32)               # k // wk
    kwh = torch.floor(kf / (wf * hk.float())).to(torch.int32)
    cx = lo[p, 0] + (k - kw * wk)
    cy = lo[p, 1] + (kw - kwh * hk)
    cz = lo[p, 2] + kwh
    keys = torch.where(in_range, (cz * ncy + cy) * ncx + cx,
                       num_cells).to(torch.int32)
    vals = torch.where(in_range, p, 0).to(torch.int32)

    # the stable sort keeps slot (hence prim) order inside a cell
    keys_sorted, perm = torch.sort(keys, stable=True)
    vals_sorted = vals[perm]
    cell_ids = torch.arange(num_cells, dtype=torch.int32, device=dev)
    cell_start = torch.searchsorted(keys_sorted, cell_ids, out_int32=True)
    cell_end = torch.searchsorted(keys_sorted, cell_ids, right=True,
                                  out_int32=True)
    return CellBinning(vals_sorted, cell_start, cell_end)
