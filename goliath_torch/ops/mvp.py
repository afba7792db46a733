"""Mixture-of-Volumetric-Primitives raymarcher (port of the march half of
the JAX package's ops/mvp.py; the reference is the CUDA extension
extensions/mvpraymarch).

Semantics:
  * K rigid box primitives, each an RGBA voxel grid ``template[K, 4, TD, TH,
    TW]`` with an SRT transform (primpos, primrot, primscale); a sample at
    x lies at y = primscale * (primrot^T (x - primpos)) in prim coords and
    counts iff |y|_inf < 1;
  * trilinear template samples (grid_sample, align_corners=False, zeros
    padding), alpha faded at the borders by exp(-fadescale * sum |y_i|^
    fadeexp);
  * additive accumulation with saturation: A += alpha * stepsize, each
    sample adds (min(A_new, 1) - A_old) * (rgb, 1), as a cumsum and clamp.

The tiled march culls prims to screen tiles by projecting their world
AABBs (``ops/binning.bin_to_tiles``, whose two prefix sums run as kernel K4
on CUDA tensors) and marches each tile's rays on a fixed step grid aligned
to the ray's tmin. It keeps the JAX march's drops exactly: a prim's tiles
are clipped to ``max_tiles_per_prim``; the pair budget is
``pair_budget_mult`` * K and slots past it are lost; each tile keeps its
first ``max_prims_per_tile`` pairs; each ray marches its nearest
``max_prims_per_ray`` hit prims; each (prim, ray) pair takes
``window_steps`` steps from its span's entry; the march takes
``max_steps`` steps. ``march_inputs`` bins and cuts the rays into tiles
(``MarchInputs``); the tiles are then marched by K8, the hand-written
forward of ``ops/mvp_cuda.py`` (CUDA tensors without gradient), or by the
plain tile groups (``march_tiles_plain``). How the plain route groups
tiles is the port's own: empty tiles are skipped, and a group holds as
many tiles as ``GROUP_TAPS`` samples allow. Window samples land on the
step grid by one ``scatter_add_`` (the JAX package's one-hot einsum
deposit, a TPU device for avoiding scatters, computes the same sums).
Under autograd each tile group is recomputed in the backward
(``torch.utils.checkpoint``, the JAX package's group remat): the binning
and the tile order stay outside the recomputed part.

``march_reference`` is the exact oracle over every prim and every ray.

The deep-shadow half (the OLAT teacher's) builds a global density grid of
the prims' alphas by gather (``splat_density_grid``, binned by
``ops/binning.bin_boxes_to_cells``, keeping the JAX package's per-block
drop) and integrates it from each light to each query point
(``shadow_at_points``: K9 of ``ops/mvp_cuda.py`` on CUDA tensors);
``shadow_at_points_exact`` integrates the prims' own fields, the grid
path's oracle.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from goliath_torch.ops.backend import target_backend
from goliath_torch.ops.binning import (bin_boxes_to_cells, bin_to_tiles,
                                       cell_spans, clip_spans)
from goliath_torch.utils.sampling import grid_sample_3d
from goliath_torch.utils.sampling import sat_int as _sat_int

# samples (taps) a tile group of the tiled march computes at once: its
# temporaries, a few hundred bytes a tap, stay within a few GiB
GROUP_TAPS = 1 << 24


def prim_world_aabb(primpos: torch.Tensor, primrot: torch.Tensor,
                    primscale: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB of each prim's [-1, 1]^3 box in world space. primscale is the
    inverse half-extent, so the half-extent along world axis i is
    sum_j |R[i, j]| / scale_j."""
    half = (primrot.abs() * (1.0 / primscale)[:, None, :]).sum(-1)  # [K, 3]
    return primpos - half, primpos + half


class MVPRenderOut(NamedTuple):
    rgba: torch.Tensor  # [R, 4]


class PackedVolume(NamedTuple):
    """Voxel rows packed for trilinear taps: row ((k*D + z)*H + y)*W + x
    holds vol[k, :, z, y, x] then vol[k, :, z, y, min(x+1, W-1)], so one
    gather of a 2C-float row fetches both x corners of every channel (the
    JAX package keeps the same table channel-first for the TPU's lanes)."""

    rows: torch.Tensor                     # [K*D*H*W, 2C]
    shape: Tuple[int, int, int, int, int]  # (K, C, D, H, W)


def pack_volume(vol: torch.Tensor) -> PackedVolume:
    """[K, C, D, H, W] -> PackedVolume (2x the memory)."""
    K, C, D, H, W = vol.shape
    nxt = torch.cat([vol[..., 1:], vol[..., -1:]], dim=-1)
    rows = torch.cat([vol, nxt], dim=1)              # [K, 2C, D, H, W]
    rows = rows.permute(0, 2, 3, 4, 1).reshape(-1, 2 * C)
    return PackedVolume(rows, (K, C, D, H, W))


def _packed(v) -> PackedVolume:
    return v if isinstance(v, PackedVolume) else pack_volume(v)


def _rows(v):
    """The tensor behind a volume, packed or not (None stays None)."""
    return v.rows if isinstance(v, PackedVolume) else v


def sample_packed_cf(pv: PackedVolume, prim_ids: torch.Tensor,
                     yx: torch.Tensor, yy: torch.Tensor, yz: torch.Tensor
                     ) -> torch.Tensor:
    """Trilinear samples of packed per-prim volumes at the coordinates yx,
    yy, yz [...] (in [-1, 1]; zeros outside): [C, ...]. prim_ids
    broadcasts against the leading axes. At x in [-1, -1 + 1/W) the second
    x corner is the packed row's vol[1], as in the JAX package."""
    K, C, D, H, W = pv.shape
    x = (yx + 1.0) * (W / 2.0) - 0.5
    v = (yy + 1.0) * (H / 2.0) - 0.5
    z = (yz + 1.0) * (D / 2.0) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(v)
    z0 = torch.floor(z)
    wx = x - x0
    wy = v - y0
    wz = z - z0
    x0i, y0i, z0i = _sat_int(x0), _sat_int(y0), _sat_int(z0)
    xin0 = (x0i >= 0) & (x0i < W)
    xin1 = (x0i + 1 >= 0) & (x0i + 1 < W)
    xc = x0i.clamp(0, W - 1)
    base = prim_ids.reshape(
        prim_ids.shape + (1,) * (yx.dim() - prim_ids.dim())).long()
    w0 = ((1 - wx) * xin0).reshape(-1, 1)
    w1 = (wx * xin1).reshape(-1, 1)
    out = None
    for dz in (0, 1):
        zi = z0i + dz
        zv = (zi >= 0) & (zi < D)
        zc = zi.clamp(0, D - 1)
        wzz = wz if dz else 1 - wz
        for dy in (0, 1):
            yi = y0i + dy
            yv = (yi >= 0) & (yi < H)
            yc = yi.clamp(0, H - 1)
            ridx = ((base * D + zc) * H + yc) * W + xc
            r = pv.rows[ridx.reshape(-1)]                  # [n, 2C]
            wyy = ((wy if dy else 1 - wy) * wzz * (zv & yv)).reshape(-1, 1)
            term = (r[:, :C] * w0 + r[:, C:] * w1) * wyy
            out = term if out is None else out + term
    return out.reshape(x.shape + (C,)).movedim(-1, 0)


def sample_packed(pv: PackedVolume, prim_ids: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """Channel-last ``sample_packed_cf``: y [..., 3] -> [..., C]."""
    return sample_packed_cf(pv, prim_ids, y[..., 0], y[..., 1],
                            y[..., 2]).movedim(0, -1)


def _pow_abs(y: torch.Tensor, fadeexp: float) -> torch.Tensor:
    """|y|^fadeexp, by repeated squaring for an integer exponent (the
    rounding of the JAX package's, which ``torch.pow`` does not share)."""
    fe = float(fadeexp)
    if fe == int(fe) and int(fe) >= 1:
        n = int(fe)
        acc = None
        bit = y.abs()
        while n:
            if n & 1:
                acc = bit if acc is None else acc * bit
            n >>= 1
            if n:
                bit = bit * bit
        return acc
    return y.abs() ** fadeexp


def sample_prims_cf(template, prim_ids: torch.Tensor, yx: torch.Tensor,
                    yy: torch.Tensor, yz: torch.Tensor, fadescale: float,
                    fadeexp: float, warp=None) -> torch.Tensor:
    """RGBA samples with the border fade, channel-first: [4, ...] (alpha
    faded and zero outside the box). With a warp field [K, 3, WD, WH, WW]
    the template is sampled at the warped coordinate while the fade and
    the validity use the coordinate before the warp (reference
    primsampler.h:44-67). ``template`` and ``warp`` may come packed."""
    fade = torch.exp(-fadescale * (_pow_abs(yx, fadeexp)
                                   + _pow_abs(yy, fadeexp)
                                   + _pow_abs(yz, fadeexp)))
    valid = (yx.abs() < 1.0) & (yy.abs() < 1.0) & (yz.abs() < 1.0)
    if warp is not None:
        w3 = sample_packed_cf(_packed(warp), prim_ids, yx, yy, yz)
        yx, yy, yz = w3[0], w3[1], w3[2]
    rgba = sample_packed_cf(_packed(template), prim_ids, yx, yy, yz)
    alpha = rgba[3] * fade * valid
    return torch.cat([rgba[:3], alpha[None]], dim=0)


def sample_prims(template, prim_ids: torch.Tensor, y: torch.Tensor,
                 fadescale: float, fadeexp: float, warp=None
                 ) -> torch.Tensor:
    """Channel-last ``sample_prims_cf``: y [CH, S, 3] -> [CH, S, 4]."""
    return sample_prims_cf(template, prim_ids, y[..., 0], y[..., 1],
                           y[..., 2], fadescale, fadeexp,
                           warp=warp).movedim(0, -1)


def saturate(alpha: torch.Tensor, stepsize: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accumulated alpha along the last axis clipped to 1, and each
    step's share of it: (A_clip, contrib), both [..., S]. The clip is
    ``jnp.minimum``'s: where A equals 1 exactly it takes half the gradient
    (``clamp`` would take all of it)."""
    A = torch.cumsum(alpha * stepsize, dim=-1)
    A_clip = torch.minimum(A, A.new_ones(()))
    contrib = torch.diff(A_clip, dim=-1,
                         prepend=torch.zeros_like(A_clip[..., :1]))
    return A_clip, contrib


def accumulate_additive(rgb: torch.Tensor, alpha: torch.Tensor,
                        stepsize: float) -> torch.Tensor:
    """Additive compositing with saturation of the samples of rays along
    the step axis (dim -1 of ``alpha`` [..., S], dim -2 of ``rgb``
    [..., S, 3]): [..., 4]."""
    A_clip, contrib = saturate(alpha, stepsize)
    rgb_out = (rgb * contrib[..., None]).sum(-2)
    a_out = A_clip[..., -1] if A_clip.shape[-1] else alpha.new_zeros(
        alpha.shape[:-1])
    return torch.cat([rgb_out, a_out[..., None]], dim=-1)


def march_reference(
    raypos: torch.Tensor,     # [R, 3]
    raydir: torch.Tensor,     # [R, 3]
    stepsize: float,
    tminmax: torch.Tensor,    # [R, 2]
    primpos: torch.Tensor,    # [K, 3]
    primrot: torch.Tensor,    # [K, 3, 3]
    primscale: torch.Tensor,  # [K, 3]
    template: torch.Tensor,   # [K, 4, TD, TH, TW]
    max_steps: int,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    warp: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact oracle: every prim on ``max_steps`` steps from each ray's
    tmin. Returns [R, 4]. Prims are sampled in blocks of at most
    GROUP_TAPS / 4 samples, whose sums are added in block order."""
    Rn, K, S = raypos.shape[0], primpos.shape[0], max_steps
    t = tminmax[:, 0:1] + stepsize * torch.arange(
        S, dtype=raypos.dtype, device=raypos.device)[None]      # [R, S]
    live = t <= tminmax[:, 1:2]
    pos = raypos[:, None] + raydir[:, None] * t[..., None]       # [R, S, 3]
    tpv = _packed(template)
    wpv = None if warp is None else _packed(warp)
    kb = max(1, (GROUP_TAPS // 4) // max(Rn * S, 1))
    alpha = rgb_w = 0.0
    for k0 in range(0, K, kb):
        ks = torch.arange(k0, min(k0 + kb, K), device=raypos.device)
        rel = pos[None] - primpos[ks][:, None, None]              # [k,R,S,3]
        y = torch.einsum("kij,krsi->krsj", primrot[ks], rel) \
            * primscale[ks][:, None, None]
        smp = sample_prims(tpv, ks, y.reshape(len(ks), -1, 3), fadescale,
                           fadeexp, warp=wpv).reshape(len(ks), Rn, S, 4)
        # several prims at one sample point: below saturation their
        # contributions sum, at saturation the clamp takes the partial
        # step, so summed alphas with the alpha-weighted mean rgb match
        # the reference's per-prim events
        alpha = alpha + smp[..., 3].sum(0)
        rgb_w = rgb_w + (smp[..., :3] * smp[..., 3:4]).sum(0)
    alpha = alpha * live
    safe_a = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    return accumulate_additive(rgb_w / safe_a[..., None], alpha, stepsize)


def _ray_box_span_g(raypos, raydir, pmin, pmax):
    """Spans of rays [g, P, 3] through boxes [g, M, 3]: ([g,M,P], [g,M,P])."""
    inv = 1.0 / torch.where(raydir.abs() < 1e-12,
                            torch.full_like(raydir, 1e-12), raydir)
    t1 = (pmin[:, :, None] - raypos[:, None]) * inv[:, None]
    t2 = (pmax[:, :, None] - raypos[:, None]) * inv[:, None]
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return tmin, tmax


def _ray_box_span(raypos, raydir, pmin, pmax):
    """Spans of rays [P, 3] through boxes [CH, 3]: ([CH, P], [CH, P])."""
    tmin, tmax = _ray_box_span_g(raypos[None], raydir[None], pmin[None],
                                 pmax[None])
    return tmin[0], tmax[0]


def _to_tiles(img_hw: torch.Tensor, ntx: int, nty: int, ts: int
              ) -> torch.Tensor:
    """[H, W, C] -> [T, P, C], the image's last row and column repeated to
    whole tiles."""
    H, W, C = img_hw.shape
    rows = torch.arange(nty * ts, device=img_hw.device).clamp(max=H - 1)
    cols = torch.arange(ntx * ts, device=img_hw.device).clamp(max=W - 1)
    x = img_hw[rows][:, cols]
    x = x.reshape(nty, ts, ntx, ts, C).permute(0, 2, 1, 3, 4)
    return x.reshape(nty * ntx, ts * ts, C)


class MarchInputs(NamedTuple):
    """What the tiled march's two routes take after the binning (built by
    ``march_inputs``): each tile's rays, its slice of the sorted pairs, the
    prims and their AABBs, and the march's sizes. K8 (``ops/mvp_cuda.py``)
    and the plain tile groups (``march_tiles_plain``) take the same."""

    raypos: torch.Tensor       # [T, P, 3] each tile's rays, row-major
    raydir: torch.Tensor       # [T, P, 3]
    tminmax: torch.Tensor      # [T, P, 2]
    tile_start: torch.Tensor   # [T] int32, into sorted_prim
    tile_end: torch.Tensor     # [T] int32
    sorted_prim: torch.Tensor  # [budget] int32
    pmin: torch.Tensor         # [K, 3] world AABBs (no gradient)
    pmax: torch.Tensor         # [K, 3]
    primpos: torch.Tensor      # [K, 3]
    primrot: torch.Tensor      # [K, 3, 3]
    primscale: torch.Tensor    # [K, 3]
    template: PackedVolume     # C 4
    warp: Optional[PackedVolume]  # C 3
    stepsize: float
    max_steps: int             # S
    window_steps: int          # Sp
    max_prims_per_tile: int    # M
    max_prims_per_ray: int     # R
    chunk: int                 # slots a plain chunk takes
    fadescale: float
    fadeexp: float
    img_h: int
    img_w: int
    ntx: int
    tile_size: int


def _count(drops: Optional[Dict[str, torch.Tensor]], key: str,
           n: torch.Tensor) -> None:
    if drops is not None:
        drops[key] = drops.get(key, 0) + n.sum()


def march_inputs(
    raypos: torch.Tensor,      # [H, W, 3]
    raydir: torch.Tensor,      # [H, W, 3]
    stepsize: float,
    tminmax: torch.Tensor,     # [H, W, 2]
    primpos: torch.Tensor,     # [K, 3]
    primrot: torch.Tensor,     # [K, 3, 3]
    primscale: torch.Tensor,   # [K, 3]
    template: torch.Tensor,    # [K, 4, TD, TH, TW]
    K_cam: torch.Tensor,       # [3, 3] camera intrinsics (tile culling)
    Rt_cam: torch.Tensor,      # [3, 4]
    max_steps: int = 128,
    tile_size: int = 16,
    max_prims_per_tile: int = 64,
    chunk: int = 16,
    max_tiles_per_prim: int = 64,
    pair_budget_mult: int = 8,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    warp: Optional[torch.Tensor] = None,  # [K, 3, WD, WH, WW]
    window_steps: Optional[int] = None,
    max_prims_per_ray: int = 16,
) -> Tuple[MarchInputs, torch.Tensor, torch.Tensor]:
    """``mvp_raymarch_tiled``'s arguments (without ``drops``) -> (the
    march's MarchInputs, and each prim's tile rect t_min, t_max [K, 2]
    int32): the prims' AABBs projected to screen tiles and binned
    (``bin_to_tiles``, K4 twice on CUDA tensors), the rays cut into
    tiles, the volumes packed. Raises ValueError where R is not a multiple
    of the chunk."""
    H, W = raypos.shape[:2]
    ts = tile_size
    ntx = -(-W // ts)
    nty = -(-H // ts)
    K = primpos.shape[0]
    # the AABBs only choose each tile's and each ray's prims, their order
    # and the first step: their derivative is 0 (in the JAX package too)
    pmin, pmax = prim_world_aabb(primpos.detach(), primrot.detach(),
                                 primscale.detach())
    # the 8 AABB corners, projected to the screen for the tile rects
    corners = torch.stack([
        torch.stack([(pmax if cx else pmin)[:, 0], (pmax if cy else pmin)[:, 1],
                     (pmax if cz else pmin)[:, 2]], -1)
        for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)], 1)  # [K, 8, 3]
    cam = torch.einsum("ij,knj->kni", Rt_cam[:3, :3], corners) + Rt_cam[:3, 3]
    z = cam[..., 2].clamp(min=1e-4)
    pix = torch.einsum("ij,knj->kni", K_cam[:2, :2],
                       cam[..., :2] / z[..., None]) + K_cam[:2, 2]
    behind = (cam[..., 2] <= 1e-4).any(dim=1)
    xy_min = pix.amin(dim=1)
    xy_max = pix.amax(dim=1)
    # prims partly behind the camera get full-screen rects
    xy_min = torch.where(behind[:, None], torch.zeros_like(xy_min), xy_min)
    xy_max = torch.where(behind[:, None], xy_max.new_tensor([[W, H]]), xy_max)
    t_min = _sat_int(torch.floor(xy_min / ts), torch.int32)
    t_max = _sat_int(torch.floor(xy_max / ts) + 1, torch.int32)
    binning = bin_to_tiles(t_min, t_max, torch.ones(
        K, dtype=torch.bool, device=raypos.device), ntx, nty,
        max_tiles_per_prim, pair_budget_mult * K)

    M = max_prims_per_tile
    R = min(max_prims_per_ray, M)
    rchunk = min(chunk, R)
    if R % rchunk:
        raise ValueError(
            f"max_prims_per_ray {R} is not a multiple of chunk {rchunk}")
    S = max_steps
    inp = MarchInputs(
        _to_tiles(raypos, ntx, nty, ts), _to_tiles(raydir, ntx, nty, ts),
        _to_tiles(tminmax, ntx, nty, ts), binning.tile_start,
        binning.tile_end, binning.sorted_prim, pmin, pmax, primpos, primrot,
        primscale, _packed(template), None if warp is None else _packed(warp),
        stepsize, S, S if window_steps is None else min(window_steps, S), M,
        R, rchunk, fadescale, fadeexp, H, W, ntx, ts)
    return inp, t_min, t_max


def march_group(inp: MarchInputs, counts, rp_g, rd_g, tm_g, pids, pm, ins,
                primpos, primrot, primscale, rows, wrows):
    """rgba [g, 4, P] of a group of tiles: the plain march of K8's work
    (``ops/csrc/mvp_march.cu``). A function of its tensor arguments alone
    (``ins``, the tiles' image rays, only for ``counts``), so the backward
    can run it again. ``counts`` (a dict, or None) receives the in-group
    drops and the deposited taps (``march_tiles_plain``)."""
    gs, P = rp_g.shape[:2]
    S, Sp, R, rchunk = (inp.max_steps, inp.window_steps,
                        inp.max_prims_per_ray, inp.chunk)
    stepsize = inp.stepsize
    dev = rp_g.device
    tpv_g = PackedVolume(rows, inp.template.shape)
    wpv_g = None if wrows is None else PackedVolume(wrows, inp.warp.shape)
    iota_Sp = torch.arange(Sp, device=dev, dtype=torch.int64)
    iota_S = torch.arange(S, device=dev, dtype=rp_g.dtype)

    # each ray's span across its tile's prims
    tmin_pk, tmax_pk = _ray_box_span_g(rp_g, rd_g, inp.pmin[pids],
                                       inp.pmax[pids])          # [g, M, P]
    hit = (tmax_pk > tmin_pk) & pm[..., None]
    inf = torch.full_like(tmin_pk, float("inf"))
    t_enter = torch.where(hit, tmin_pk, inf).amin(dim=1)     # [g, P]
    t_exit = torch.where(hit, tmax_pk, -inf).amax(dim=1)
    t_enter = torch.maximum(t_enter, tm_g[..., 0])
    t_exit = torch.minimum(t_exit, tm_g[..., 1])
    any_hit = torch.isfinite(t_enter) & (t_exit > t_enter)
    t_enter = torch.where(any_hit, t_enter, torch.zeros_like(t_enter))
    t_exit = torch.where(any_hit, t_exit, torch.full_like(t_exit, -1.0))

    # each ray's R nearest hit prims by entry depth (a stable sort:
    # the JAX package's is unstable, which only orders equal depths)
    keyT = torch.where(hit, tmin_pk, inf).transpose(1, 2)    # [g, P, M]
    key_s, slot_s = torch.sort(keyT, dim=2, stable=True)
    slotR = slot_s[..., :R]                                 # [g, P, R]
    hitR = torch.isfinite(key_s[..., :R])

    # steps on the grid of the ray's tmin, as the CUDA kernel aligns
    # them (mvpraymarch_subset_kernel.h:76-79)
    t0 = tm_g[..., 0] + torch.floor(
        (t_enter - tm_g[..., 0]).clamp(min=0.0) / stepsize) * stepsize
    if counts is not None:
        _count(counts, "rays_over_r", (hit.sum(1) > R) & ins)
        _count(counts, "rays_step_capped", any_hit & ins & (
            t0 + (S - 1) * stepsize + 1e-5 < t_exit))

    # taps [g, P, rc, Sp]: each ray's slots, each slot's window steps
    acc = rp_g.new_zeros(gs, P, 4, S)
    for ci in range(R // rchunk):
        if ci and not bool((hitR.sum(2) > ci * rchunk).any()):
            break   # hit slots are sorted first: no ray has more
        c0 = ci * rchunk
        sl = slotR[..., c0:c0 + rchunk]                     # [g, P, rc]
        hm = hitR[..., c0:c0 + rchunk]
        gp = pids.gather(1, sl.reshape(gs, -1)).reshape(sl.shape)
        # prim coords along the ray: y_j(t) = A_j t + B_j
        Rr = primrot[gp]                                    # [g,P,rc,3,3]
        psc = primscale[gp]                                 # [g,P,rc,3]
        Ac = torch.einsum("gpkij,gpi->gpkj", Rr, rd_g) * psc
        rel0 = rp_g[:, :, None] - primpos[gp]               # [g,P,rc,3]
        Bc = torch.einsum("gpkij,gpki->gpkj", Rr, rel0) * psc
        # spans of the oriented slabs |y_j(t)| < 1, the exact support
        # of the samples' validity
        invA = 1.0 / torch.where(Ac.abs() < 1e-12,
                                 torch.full_like(Ac, 1e-12), Ac)
        t1 = (-1.0 - Bc) * invA
        t2 = (1.0 - Bc) * invA
        tmin_c = torch.minimum(t1, t2).amax(dim=-1)           # [g,P,rc]
        tmax_c = torch.maximum(t1, t2).amin(dim=-1)
        ok = (tmax_c > tmin_c) & hm
        s_lo = _sat_int(torch.ceil(
            (tmin_c - t0[..., None]) / stepsize - 1e-5)).clamp(0, S - 1)
        sidx = s_lo[..., None] + iota_Sp                      # [g,P,rc,Sp]
        tj = t0[..., None, None] + sidx * stepsize
        msk = (ok[..., None] & (tj <= tmax_c[..., None] + 1e-5)
               & (sidx < S))
        yx = Ac[..., 0, None] * tj + Bc[..., 0, None]
        yy = Ac[..., 1, None] * tj + Bc[..., 1, None]
        yz = Ac[..., 2, None] * tj + Bc[..., 2, None]
        smp = sample_prims_cf(tpv_g, gp[..., None], yx, yy, yz,
                              inp.fadescale, inp.fadeexp,
                              warp=wpv_g)                   # [4,g,P,rc,Sp]
        a = smp[3] * msk
        vals = torch.stack([smp[0] * a, smp[1] * a, smp[2] * a, a], 2)
        # deposit each window onto the step grid at s_lo + j
        acc.scatter_add_(
            3, sidx.clamp(max=S - 1).reshape(gs, P, 1, -1).expand(
                gs, P, 4, -1), vals.reshape(gs, P, 4, -1))
        if counts is not None:
            past = (ok & (s_lo + Sp < S) & (
                t0[..., None] + (s_lo + Sp) * stepsize
                <= tmax_c + 1e-5) & ins[..., None])
            _count(counts, "window_cut_pairs", past)
            _count(counts, "taps", msk)
            counts["cut_prims"][gp[past]] = True

    steps_t = t0[..., None] + stepsize * iota_S               # [g, P, S]
    live_s = (steps_t <= t_exit[..., None] + 1e-5) & any_hit[..., None]
    alpha = acc[:, :, 3] * live_s
    safe = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    rgb_mean = acc[:, :, :3] / safe[:, :, None]
    A_clip, contrib = saturate(alpha, stepsize)
    rgb_out = (rgb_mean * contrib[:, :, None]).sum(-1)      # [g, P, 3]
    return torch.cat([rgb_out, A_clip[..., -1:]], -1).transpose(1, 2)


# the in-group counts of the march (``march_tiles_plain`` and K8): the
# drops of ``mvp_raymarch_tiled``'s ``drops`` and the taps it deposited
MARCH_COUNTS = ("taps", "rays_over_r", "rays_step_capped",
                "window_cut_pairs", "window_cut_prims")


def image_rays(inp: MarchInputs) -> torch.Tensor:
    """[T, P] bool: which of the tiles' rays are image pixels (the tiles
    of the last row and column run past the image)."""
    T, P = inp.raypos.shape[:2]
    ts = inp.tile_size
    nty = T // inp.ntx
    inside = torch.zeros(nty * ts, inp.ntx * ts, dtype=torch.bool,
                         device=inp.raypos.device)
    inside[:inp.img_h, :inp.img_w] = True
    return inside.reshape(nty, ts, inp.ntx, ts).permute(0, 2, 1, 3) \
        .reshape(T, P)


def march_group_tiles(inp: MarchInputs) -> int:
    """Tiles a plain group marches at once: as many as GROUP_TAPS samples
    allow (the JAX package's ``tile_group``)."""
    P = inp.tile_size * inp.tile_size
    return max(1, GROUP_TAPS // (inp.chunk * inp.window_steps * P))


def march_tiles_plain(inp: MarchInputs, counts: Optional[dict] = None,
                      recompute: bool = False) -> torch.Tensor:
    """The plain march of every tile: rgba [T, 4, P]. Empty tiles march
    nothing (their rgba is 0; one host sync a call), the others go in
    groups of ``march_group_tiles`` through ``march_group``. With
    ``recompute`` each group runs under ``torch.utils.checkpoint`` and is
    marched again in the backward. ``counts`` (a dict, or None) receives
    MARCH_COUNTS as 0-dim int64 tensors."""
    T, P = inp.raypos.shape[:2]
    M = inp.max_prims_per_tile
    budget = inp.sorted_prim.shape[0]
    dev = inp.raypos.device
    tile_counts = inp.tile_end - inp.tile_start
    inside = None
    if counts is not None:
        for key in MARCH_COUNTS[:4]:
            counts[key] = torch.zeros((), dtype=torch.int64, device=dev)
        counts["cut_prims"] = torch.zeros(inp.primpos.shape[0],
                                          dtype=torch.bool, device=dev)
        inside = image_rays(inp)
    live = torch.nonzero(tile_counts > 0).squeeze(1)
    g = march_group_tiles(inp)
    out = inp.raypos.new_zeros(T, 4, P)
    for i0 in range(0, live.numel(), g):
        idx = live[i0:i0 + g]
        idxs = inp.tile_start[idx][:, None] + torch.arange(
            M, device=dev, dtype=torch.int32)                   # [g, M]
        pm = idxs < inp.tile_end[idx][:, None]
        pids = inp.sorted_prim[idxs.clamp(0, budget - 1).long()].long()
        args = (inp.raypos[idx], inp.raydir[idx], inp.tminmax[idx], pids, pm,
                None if inside is None else inside[idx], inp.primpos,
                inp.primrot, inp.primscale, inp.template.rows,
                None if inp.warp is None else inp.warp.rows)
        # under autograd the group's taps are recomputed in the backward
        # (one group's temporaries alive at a time); the binning, the tile
        # order and the groups stay as this pass made them
        out[idx] = (checkpoint(march_group, inp, None, *args,
                               use_reentrant=False)
                    if recompute else march_group(inp, counts, *args))
    if counts is not None:
        counts["window_cut_prims"] = counts.pop("cut_prims").sum()
    return out


def mvp_raymarch_tiled(
    raypos: torch.Tensor,      # [H, W, 3]
    raydir: torch.Tensor,      # [H, W, 3]
    stepsize: float,
    tminmax: torch.Tensor,     # [H, W, 2]
    primpos: torch.Tensor,     # [K, 3]
    primrot: torch.Tensor,     # [K, 3, 3]
    primscale: torch.Tensor,   # [K, 3]
    template: torch.Tensor,    # [K, 4, TD, TH, TW]
    K_cam: torch.Tensor,       # [3, 3] camera intrinsics (tile culling)
    Rt_cam: torch.Tensor,      # [3, 4]
    max_steps: int = 128,
    tile_size: int = 16,
    max_prims_per_tile: int = 64,
    chunk: int = 16,
    max_tiles_per_prim: int = 64,
    pair_budget_mult: int = 8,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    warp: Optional[torch.Tensor] = None,  # [K, 3, WD, WH, WW]
    window_steps: Optional[int] = None,
    max_prims_per_ray: int = 16,
    drops: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Tile-culled fixed-step MVP march. Returns the rgba image [4, H, W].

    Rays and prims are in the normalized volume frame (the Raymarcher
    divides by volradius); K_cam / Rt_cam only cull prims to tiles and
    must match the rays.

    ``window_steps`` (Sp): each (prim, ray) pair samples Sp grid steps from
    the first step inside the prim's oriented box, exact while the box's
    span fits Sp steps (the tail is dropped otherwise; None = max_steps).
    ``max_prims_per_ray`` (R): each ray marches the R tile prims it enters
    first, in chunks of ``chunk`` slots; farther hits are dropped. R must
    be a multiple of the chunk (ValueError otherwise): the JAX package's
    last chunk would then start at R - chunk and march again the slots it
    shares with the chunk before, in whichever of its tile groups some ray
    needs that chunk. Tiles are marched in groups of as many as
    GROUP_TAPS samples allow (the JAX package's ``tile_group``).

    Route: the binning (``march_inputs``) always runs here, its two prefix
    sums on K4 for CUDA tensors. The tiles are then marched by K8
    (``mvp_cuda.mvp_march``, one launch for every tile, no host sync) when
    the tensors lie on a CUDA device and no input needs a gradient (or
    gradient is off); otherwise by the plain tile groups
    (``march_tiles_plain``): on the CPU and under autograd (every training
    step). On the card K8 takes an integer ``fadeexp`` of at least 1 and
    raises ValueError for any other; a K8 that fails to build or launch
    raises too.

    With ``drops`` given (a dict), the march adds to it what each drop
    removed, as tensors: ``pairs_wanted`` (tile pairs after the per-prim
    clip) against ``pair_budget``, ``prims_clipped``, ``prims_dropped``
    (not one tile binned) and ``prims_cut`` (some tiles binned),
    ``tiles_full`` (lists that hit max_prims_per_tile),
    ``pairs_past_list`` and ``max_tile_list`` (the longest list before the
    cut), ``rays_over_r`` (image rays with more than R hit
    prims in their tile's list), ``window_cut_pairs`` and
    ``window_cut_prims`` ((prim, ray) pairs and prims whose span went past
    the window), ``rays_step_capped`` (hits past max_steps), and
    ``tiles_marched`` and ``group_tiles`` (the plain route's group size,
    on either route); the last five are counted in the march itself (by
    K8 on its route); with gradient enabled on an input that needs one it
    raises ValueError instead (the recomputed groups would count twice).

    Under autograd (grad enabled, an input needing gradient) each group is
    marched again in the backward (``torch.utils.checkpoint``), as the JAX
    package rematerializes its groups: the forward keeps no tap's
    temporaries. The prims' AABBs, which pick the tiles, each ray's prims
    and its first step, carry no gradient.
    """
    recompute = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in (
            primpos, primrot, primscale, _rows(template), _rows(warp)))
    if recompute and drops is not None:
        raise ValueError("the march counts drops without gradient: call it "
                         "under torch.no_grad()")
    inp, t_min, t_max = march_inputs(
        raypos, raydir, stepsize, tminmax, primpos, primrot, primscale,
        template, K_cam, Rt_cam, max_steps, tile_size, max_prims_per_tile,
        chunk, max_tiles_per_prim, pair_budget_mult, fadescale, fadeexp,
        warp, window_steps, max_prims_per_ray)
    ntx = inp.ntx
    nty = inp.raypos.shape[0] // ntx
    K = primpos.shape[0]
    M = max_prims_per_tile
    counts = inp.tile_end - inp.tile_start                      # [T]

    if drops is not None:
        budget = pair_budget_mult * K
        _, _, w, h = clip_spans(t_min, t_max, ntx, nty, max_tiles_per_prim)
        n = w * h
        area = ((t_max[:, 0].clamp(0, ntx) - t_min[:, 0].clamp(0, ntx))
                .clamp(min=0) * (t_max[:, 1].clamp(0, nty)
                                 - t_min[:, 1].clamp(0, nty)).clamp(min=0))
        off = torch.cumsum(n, 0) - n
        drops["pair_budget"] = torch.tensor(budget)
        _count(drops, "pairs_wanted", n)
        _count(drops, "prims_clipped", area > max_tiles_per_prim)
        _count(drops, "prims_dropped", (n > 0) & (off >= budget))
        _count(drops, "prims_cut", (off < budget) & (off + n > budget))
        _count(drops, "tiles_full", counts >= M)
        drops["max_tile_list"] = counts.max()
        _count(drops, "pairs_past_list", (counts - M).clamp(min=0))

    in_group = None if drops is None else {}
    if target_backend(raypos) == "cuda" and not recompute:
        from goliath_torch.ops import mvp_cuda

        out, in_group = mvp_cuda.mvp_march(inp, drops is not None)
    else:
        out = march_tiles_plain(inp, in_group, recompute)
    if drops is not None:
        drops["tiles_marched"] = (counts > 0).sum()
        drops["group_tiles"] = torch.tensor(march_group_tiles(inp))
        for key in MARCH_COUNTS[1:]:
            _count(drops, key, in_group[key])
    return untile(inp, out)


def untile(inp: MarchInputs, out: torch.Tensor) -> torch.Tensor:
    """The march's tiles' rgba [T, 4, P] as the image [4, H, W]."""
    ts, ntx = inp.tile_size, inp.ntx
    nty = out.shape[0] // ntx
    img = out.reshape(nty, ntx, 4, ts, ts).permute(2, 0, 3, 1, 4)
    return img.reshape(4, nty * ts, ntx * ts)[:, :inp.img_h, :inp.img_w]


# ---------------------------------------------------------------------------
# deep shadow volumes (the JAX package's replacement of mvpraymarch's
# shadow splatting, reference extensions/mvpraymarch primsplatter.h:14-38)
# ---------------------------------------------------------------------------


def splat_density_grid(
    primpos: torch.Tensor,     # [K, 3] (normalized volume frame)
    primrot: torch.Tensor,     # [K, 3, 3]
    primscale: torch.Tensor,   # [K, 3]
    primalpha: torch.Tensor,   # [K, Z, Y, X] per-voxel alpha density
    grid_res: int = 64,
    block: int = 8,
    max_prims_per_block: int = 64,
    chunk: int = 16,
    max_cells_per_prim: int = 512,
    pair_budget_mult: int = 128,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
    drops: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The prims' alpha fields resampled onto a global [-1, 1]^3 grid
    [G, G, G] (indexed z, y, x): D(x) = sum_k alpha_k(x) * fade_k(x), by
    gather. Prims are binned to blocks of ``block``^3 cells by their world
    AABBs (``bin_boxes_to_cells``), and each block sums the trilinear alpha
    of its first nchunks * chunk pairs (nchunks = max_prims_per_block //
    chunk) in prim-index order at its cell centres, chunk by chunk, as the
    JAX package does: the block's later pairs are lost.

    Only blocks with pairs are evaluated (one host sync); the others are 0.
    With ``drops`` given (a dict), adds to it as tensors: ``pair_budget``,
    ``pairs_wanted`` (cell pairs after the per-prim crop), ``pairs_binned``,
    ``blocks_binned`` (blocks with pairs), ``blocks_full`` (blocks with
    more pairs than they evaluate), ``pairs_past_block``,
    ``max_block_list``, ``prims_binned`` (prims with a binned pair),
    ``prims_kept`` (prims with an evaluated pair) and ``prims_dropped``
    (binned, but in no evaluated pair).
    """
    K = primalpha.shape[0]
    G = grid_res
    if G % block:
        raise ValueError(f"grid_res {G} is not a multiple of block {block}")
    dev = primpos.device
    NB = G // block
    P3 = block ** 3

    pmin, pmax = prim_world_aabb(primpos, primrot, primscale)

    def to_cell(p):
        return (p + 1.0) * 0.5 * G / block

    bmin = _sat_int(torch.floor(to_cell(pmin)), torch.int32)
    bmax = _sat_int(torch.floor(to_cell(pmax)), torch.int32) + 1
    budget = pair_budget_mult * K
    valid = torch.ones(K, dtype=torch.bool, device=dev)
    binning = bin_boxes_to_cells(bmin, bmax, valid, (NB, NB, NB),
                                 max_cells_per_prim, budget)
    nchunks = max(max_prims_per_block // chunk, 1)
    M = nchunks * chunk                       # pairs a block evaluates
    counts = binning.cell_end - binning.cell_start            # [NB^3]

    # cell centres per block, [NB^3, P3, 3] in (x, y, z) order
    bi = torch.arange(NB, dtype=torch.int32, device=dev)
    bz, by, bx = torch.meshgrid(bi, bi, bi, indexing="ij")
    borig = torch.stack([bx, by, bz], -1).reshape(-1, 1, 3) * block
    li = torch.arange(block, dtype=torch.int32, device=dev)
    lz, ly, lx = torch.meshgrid(li, li, li, indexing="ij")
    local = torch.stack([lx, ly, lz], -1).reshape(1, -1, 3)
    pos = ((borig + local).float() + 0.5) / G * 2.0 - 1.0

    alpha_pv = pack_volume(primalpha[:, None])
    slots = torch.arange(M, dtype=torch.int32, device=dev)
    live = torch.nonzero(counts > 0).squeeze(1)
    dens = primpos.new_zeros(NB ** 3, P3)
    g = max(1, GROUP_TAPS // (M * P3))
    for i0 in range(0, live.numel(), g):
        blk = live[i0:i0 + g]
        idx = binning.cell_start[blk][:, None] + slots               # [b, M]
        kept = idx < binning.cell_end[blk][:, None]
        cp = binning.sorted_prim[idx.clamp(0, budget - 1).long()].long()
        rel = pos[blk][:, None] - primpos[cp][:, :, None]            # [b,M,P3,3]
        y = torch.einsum("bkij,bkpi->bkpj", primrot[cp], rel) \
            * primscale[cp][:, :, None]
        a = sample_packed(alpha_pv, cp, y)[..., 0]                   # [b,M,P3]
        fade = torch.exp(-fadescale * (_pow_abs(y[..., 0], fadeexp)
                                       + _pow_abs(y[..., 1], fadeexp)
                                       + _pow_abs(y[..., 2], fadeexp)))
        inside = (y.abs() < 1.0).all(-1)
        a = a * fade * inside * kept[..., None]
        sums = a.reshape(len(blk), nchunks, chunk, P3).sum(2)
        acc = sums[:, 0]
        for c in range(1, nchunks):
            acc = acc + sums[:, c]
        dens[blk] = acc

    if drops is not None:
        _, span = cell_spans(bmin, bmax, (NB, NB, NB), max_cells_per_prim)
        pairs = binning.sorted_prim[:int(counts.sum())].long()
        first = torch.repeat_interleave(binning.cell_start.long(), counts)
        rank = torch.arange(pairs.numel(), device=dev) - first
        binned = torch.zeros(K, dtype=torch.bool, device=dev)
        binned[pairs] = True
        in_grid = torch.zeros(K, dtype=torch.bool, device=dev)
        in_grid[pairs[rank < M]] = True
        drops["pair_budget"] = torch.tensor(budget)
        _count(drops, "pairs_wanted", span.prod(1))
        _count(drops, "pairs_binned", counts)
        _count(drops, "blocks_binned", counts > 0)
        _count(drops, "blocks_full", counts > M)
        _count(drops, "pairs_past_block", (counts - M).clamp(min=0))
        drops["max_block_list"] = counts.max()
        _count(drops, "prims_binned", binned)
        _count(drops, "prims_kept", in_grid)
        _count(drops, "prims_dropped", binned & ~in_grid)

    dens = dens.reshape(NB, NB, NB, block, block, block)  # bz,by,bx,lz,ly,lx
    return dens.permute(0, 3, 1, 4, 2, 5).reshape(G, G, G)


def shadow_at_points(
    density: torch.Tensor,     # [G, G, G] (z, y, x)
    points: torch.Tensor,      # [M, 3] (normalized frame)
    light_pos: torch.Tensor,   # [3]
    n_steps: int = 32,
    point_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Accumulated alpha (clamped to 1) from the light to each point, [M]:
    ``n_steps`` midpoint samples of ``density`` on the segment from where
    the light's ray enters the [-1, 1] volume to the point.

    On CUDA tensors K9 (``mvp_cuda.shadow_integral``) takes every point in
    one launch; it computes no gradient, so with gradient enabled on a
    ``density`` or ``points`` that needs one it raises ValueError. On CPU tensors points go in chunks of ``point_chunk``
    (GROUP_TAPS // n_steps when None; a bound of the live set, not of the
    result: the teacher at full width queries 8.4M points a light) through
    ``_shadow_at_points_impl``, K9's plain version."""
    from goliath_torch.ops import mvp_cuda

    if target_backend(density) == "cuda":
        if torch.is_grad_enabled() and (density.requires_grad
                                        or points.requires_grad):
            raise ValueError("K9 computes no gradient: call shadow_at_points "
                             "on the card under torch.no_grad() or on "
                             "tensors that need none")
        return mvp_cuda.shadow_integral(density, points, light_pos, n_steps)
    if point_chunk is None:
        point_chunk = max(1, GROUP_TAPS // n_steps)
    return torch.cat([
        _shadow_at_points_impl(density, points[i:i + point_chunk],
                               light_pos, n_steps)
        for i in range(0, points.shape[0], point_chunk)]) \
        if points.shape[0] else points.new_zeros(0)


def _norm(d: torch.Tensor) -> torch.Tensor:
    """|d| over the last axis, keepdim, as jnp.linalg.norm sums it."""
    return torch.sqrt((d * d).sum(-1, keepdim=True))


def _shadow_at_points_impl(density, points, light_pos, n_steps):
    d = points - light_pos[None]
    dist = _norm(d)
    dirn = d / dist.clamp(min=1e-8)
    # the segment clipped to the [-1, 1] volume; a component under 1e-12
    # in magnitude becomes +1e-12, its sign dropped, as in the JAX package
    inv = 1.0 / torch.where(dirn.abs() < 1e-12,
                            torch.full_like(dirn, 1e-12), dirn)
    t1 = (-1.0 - light_pos[None]) * inv
    t2 = (1.0 - light_pos[None]) * inv
    t_enter = torch.minimum(t1, t2).amax(-1, keepdim=True).clamp(min=0.0)
    seg = (dist - t_enter).clamp(min=0.0)            # to the point, [M, 1]
    frac = (torch.arange(n_steps, dtype=points.dtype, device=points.device)
            + 0.5) / n_steps
    ts = t_enter + seg * frac[None]                                  # [M, S]
    pos = light_pos[None, None] + dirn[:, None] * ts[..., None]      # [M,S,3]
    dens = grid_sample_3d(density[None], pos, padding_mode="zeros")[0]
    acc = dens.sum(-1) * (seg[:, 0] / n_steps)
    return acc.clamp(0.0, 1.0)


def shadow_at_points_exact(
    primpos: torch.Tensor,     # [K, 3] (normalized volume frame)
    primrot: torch.Tensor,     # [K, 3, 3]
    primscale: torch.Tensor,   # [K, 3]
    primalpha: torch.Tensor,   # [K, Z, Y, X]
    points: torch.Tensor,      # [M, 3] (normalized frame)
    light_pos: torch.Tensor,   # [3]
    n_steps: int = 64,
    fadescale: float = 8.0,
    fadeexp: float = 8.0,
) -> torch.Tensor:
    """The brute-force deep shadow, the grid path's oracle: the true
    per-prim trilinear alpha fields (``grid_sample_3d``, zeros padding)
    integrated on ``n_steps`` midpoint samples of the whole segment from
    the light to each point, prims added in index order; accumulated alpha
    clamped to 1, [M]. O(K * M * n_steps): for parity studies."""
    d = points - light_pos[None]
    dist = _norm(d)
    dirn = d / dist.clamp(min=1e-8)
    ts = dist * ((torch.arange(n_steps, dtype=points.dtype,
                               device=points.device)[None] + 0.5) / n_steps)
    pos = light_pos[None, None] + dirn[:, None] * ts[..., None]      # [M,S,3]
    dens = torch.zeros(pos.shape[:2], dtype=points.dtype,
                       device=points.device)
    for k in range(primpos.shape[0]):
        y = torch.einsum("ij,msi->msj", primrot[k], pos - primpos[k]) \
            * primscale[k]
        a = grid_sample_3d(primalpha[k][None], y)[0]
        fade = torch.exp(-fadescale * (_pow_abs(y[..., 0], fadeexp)
                                       + _pow_abs(y[..., 1], fadeexp)
                                       + _pow_abs(y[..., 2], fadeexp)))
        dens = dens + a * fade * (y.abs() < 1.0).all(-1)
    acc = dens.sum(-1) * (dist[:, 0] / n_steps)
    return acc.clamp(0.0, 1.0)
