"""The render split over a mesh axis: the screen's tile rows in bands, or
the primitives in depth slabs (port of the JAX package's
parallel/tile_shard.py).

* ``render_tile_sharded``: each shard of ``mesh[axis]`` bins and composites
  one horizontal BAND of screen tiles (the gaussians replicated, the band
  binned by ``prepare_sample(y_offset_px=..., bin_img_h=...)``), with a
  pair budget of ~1/nbands of the full render's. The bands are
  concatenated along H. Gradients of the replicated inputs are the sums of
  the bands' (autograd; ``.to`` brings a band's gradient home from its
  device, as shard_map's AD inserts the psum).
* ``composite_over``: the associative over-operator of a depth-slab split:
  (C1, T1) over (C2, T2) = (C1 + T1*C2, T1*T2).
* ``render_prim_sharded``: each shard renders a contiguous depth slab of
  the gaussians (a stable argsort of the exact depths) over the full
  image, and the slabs' (color, transmittance) pairs fold front to back
  with ``composite_over``.

Every band and every slab runs K4 twice in its binning and K1 (or K1's XLA
window without ``use_pallas``) in its compositor, and K2 and K3 under
autograd. As in the JAX package, the band render never takes the
batch-folded render (``GOLIATH_GSPLAT_FOLD``), and the slab render calls
``gsplat.render`` once a slab, which folds under it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from goliath_torch.ops import gsplat, gsplat_cuda
from goliath_torch.parallel.sharding import Mesh


def composite_over(a, b):
    """Associative 'over' combine of (color [..., C, H, W], transmittance
    [..., H, W]) pairs: front slab a over back slab b."""
    ca, ta = a
    cb, tb = b
    return ca + ta[..., None, :, :] * cb, ta * tb


def _finish(out, T_final, return_depth, bg_color):
    """The render's dict from color (and depth) [B, C', H, W] and T
    [B, H, W], with ``bg_color`` applied last."""
    rgb = out[:, :3]
    alpha = (1.0 - T_final)[:, None]
    if bg_color is not None:
        rgb = rgb + T_final[:, None] * bg_color[None, :, None, None]
    result = {"render": rgb, "final_T": T_final[:, None], "alpha": alpha}
    if return_depth:
        result["depth"] = out[:, 3:4]
    return result


def render_prim_sharded(
    mesh: Mesh,
    axis: str,
    cam_img_w: int,
    cam_img_h: int,
    K: torch.Tensor,           # [B, 3, 3]
    Rt: torch.Tensor,          # [B, 3or4, 4]
    primpos: torch.Tensor,     # [B, N, 3]
    primqvec: torch.Tensor,    # [B, N, 4]
    primscale: torch.Tensor,   # [B, N, 3]
    opacity: torch.Tensor,     # [B, N, 1]
    colors: torch.Tensor,      # [B, N, 3]
    return_depth: bool = True,
    bg_color: Optional[torch.Tensor] = None,
    **render_kwargs,
) -> Dict[str, torch.Tensor]:
    """``gsplat.render`` with the PRIMITIVE axis split in depth slabs over
    ``mesh[axis]``: shard s takes slots [s*slab, (s+1)*slab) of each
    sample's stable argsort of ``pos @ Rt[2, :3] + Rt[2, 3]``, the tail
    padded with prim N-1 at opacity 0, and renders them over the full
    image (no ``bg_color``, ``render_kwargs`` as given: each slab has its
    own pair budget of ``pair_budget_mult`` * slab and its own
    ``max_pairs_per_tile`` window). The slabs' (color and depth,
    transmittance) fold front to back with ``composite_over`` in slab
    order; ``bg_color`` is applied last."""
    nslabs = mesh.shape[axis]
    B, N = primpos.shape[:2]
    n_pad = (-N) % nslabs
    slab = (N + n_pad) // nslabs
    home = primpos.device
    live = torch.cat([torch.ones(N, dtype=opacity.dtype, device=home),
                      torch.zeros(n_pad, dtype=opacity.dtype, device=home)])
    orders = []
    for b in range(B):
        depth = primpos[b] @ Rt[b, 2, :3] + Rt[b, 2, 3]
        order = torch.argsort(depth.detach(), stable=True)
        orders.append(torch.cat([order, order.new_full((n_pad,), N - 1)]))
    acc = None
    for s, dev in enumerate(mesh.axis_devices(axis, through=home)):
        sel = slice(s * slab, (s + 1) * slab)
        take = torch.stack([o[sel] for o in orders])          # [B, slab]

        def pick(x):
            return torch.stack([x[b][take[b]] for b in range(B)]).to(dev)

        op = pick(opacity) * live[sel].to(dev)[None, :, None]
        out = gsplat.render(
            cam_img_w, cam_img_h, K.to(dev), Rt.to(dev), pick(primpos),
            pick(primqvec), pick(primscale), op, pick(colors),
            return_depth=return_depth, bg_color=None, **render_kwargs)
        C = torch.cat([out["render"]]
                      + ([out["depth"]] if return_depth else []), dim=1)
        part = (C.to(home), out["final_T"][:, 0].to(home))
        acc = part if acc is None else composite_over(acc, part)
    return _finish(acc[0], acc[1], return_depth, bg_color)


def band_geometry(cam_img_w: int, cam_img_h: int, tile_size: int,
                  nbands: int, n_prims: int, pair_budget_mult: float,
                  max_tiles_per_prim: int):
    """(ntx, band_nty, band_h, pair_budget) of a render split in ``nbands``
    bands: each band is ceil(nty / nbands) tile rows high, and its pair
    budget is the full budget over the band count, at least
    8 * max_tiles_per_prim (the JAX package's rule)."""
    ntx = -(-cam_img_w // tile_size)
    nty = -(-cam_img_h // tile_size)
    band_nty = -(-nty // nbands)
    pair_budget = max(int(round(pair_budget_mult * n_prims / nbands)),
                      8 * max_tiles_per_prim)
    return ntx, band_nty, band_nty * tile_size, pair_budget


def render_tile_sharded(
    mesh: Mesh,
    axis: str,
    cam_img_w: int,
    cam_img_h: int,
    K: torch.Tensor,           # [B, 3, 3]
    Rt: torch.Tensor,          # [B, 3or4, 4]
    primpos: torch.Tensor,     # [B, N, 3]
    primqvec: torch.Tensor,    # [B, N, 4]
    primscale: torch.Tensor,   # [B, N, 3]
    opacity: torch.Tensor,     # [B, N, 1]
    colors: torch.Tensor,      # [B, N, 3]
    return_depth: bool = True,
    bg_color: Optional[torch.Tensor] = None,
    tile_size: int = 32,
    global_scale: float = 1.0,
    z_near: float = 0.1,
    max_tiles_per_prim: int = 64,
    max_pairs_per_tile: int = 1024,
    chunk: int = 256,
    pair_budget_mult: float = 2,
    use_pallas: bool = False,
    pallas_inner: int = 64,
) -> Dict[str, torch.Tensor]:
    """``gsplat.render`` with the screen's tile rows split in bands over
    ``mesh[axis]``: band i (``band_geometry``: ``band_h`` rows from
    y0 = i * band_h) is binned and composited on the i-th device along the
    axis (on the mesh's line through the inputs' device), per sample, with
    K1's Pallas window under ``use_pallas`` and the XLA compositor's
    otherwise; the bands are concatenated along H, cropped to
    ``cam_img_h``, and ``bg_color`` is applied after the crop.
    ``pallas_inner`` selects nothing (see ops/gsplat.py)."""
    del pallas_inner
    nbands = mesh.shape[axis]
    ts = tile_size
    B, N = primpos.shape[:2]
    ntx, band_nty, band_h, pair_budget = band_geometry(
        cam_img_w, cam_img_h, ts, nbands, N, pair_budget_mult,
        max_tiles_per_prim)
    window = "pallas" if use_pallas else "xla"
    home = primpos.device
    outs, Ts = [], []
    for i, dev in enumerate(mesh.axis_devices(axis, through=home)):
        band_out, band_T = [], []
        for b in range(B):
            xys, conics, op_s, chan, valid, _radii, binning = \
                gsplat.prepare_sample(
                    K[b].to(dev), Rt[b].to(dev), primpos[b].to(dev),
                    primqvec[b].to(dev), primscale[b].to(dev),
                    opacity[b].to(dev), colors[b].to(dev), cam_img_h,
                    cam_img_w, ts, z_near, global_scale, max_tiles_per_prim,
                    pair_budget, return_depth, y_offset_px=i * band_h,
                    bin_img_h=band_h)
            out, T_final = gsplat_cuda.rasterize_tiled(
                xys, conics, op_s, chan, valid, binning.sorted_prim,
                binning.tile_start, binning.tile_end, binning.perm,
                binning.prim_offsets, binning.prim_ends, band_h, cam_img_w,
                ts, max_pairs_per_tile, chunk, ntx, band_nty, window=window)
            band_out.append(out.to(home))
            band_T.append(T_final.to(home))
        outs.append(torch.stack(band_out))     # [B, C, band_h, W]
        Ts.append(torch.stack(band_T))         # [B, band_h, W]
    out = torch.cat(outs, dim=2)[:, :, :cam_img_h]
    T_final = torch.cat(Ts, dim=1)[:, :cam_img_h]
    return _finish(out, T_final, return_depth, bg_color)
