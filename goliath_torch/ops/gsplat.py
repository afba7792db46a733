"""3D Gaussian splatting (port of the JAX package's ops/gsplat.py).

Pipeline per sample:
  * ``project_gaussians`` — EWA projection: quat/scale -> cov3d ->
    perspective Jacobian -> cov2d (+0.3px blur with det-ratio
    compensation), conics, per-axis 3-sigma extents;
  * log depth quantized into a composite (tile << bits | qdepth) sort key,
    and ``bin_to_tiles`` (ops/binning.py, prefix sums on K4) groups the
    pairs per screen tile in depth order;
  * the tiled compositor K1 (ops/gsplat_cuda.py) composites each tile front
    to back and early-outs once the tile is opaque.
``rasterize_reference`` is the exact O(pixels x gaussians) oracle.

With ``GOLIATH_GSPLAT_FOLD=1``, ``use_pallas`` and a batch over 1,
``render`` takes the batch-folded path of the JAX package (``_render_folded``
here): the B images stacked vertically in tile space, one binning, one
compositor launch (K6) and one backward reduce for the batch.

Gradients: the compositor has a hand-written backward, as in the JAX
package (``gsplat_cuda.RasterizeTiled``: K2 computes per-pair gradients,
``reduce_sorted_pair_grads`` here sums them per primitive on the scan K3).
Projection and everything before it differentiate by plain autograd; the
binning carries no gradient.

The compositor is always K1 (the kernel on CUDA tensors, its plain version
on CPU tensors). ``render``'s ``use_pallas`` selects its block window, as it
selects the compositor in the JAX package: true takes the Pallas kernel's
(chunk-aligned blocks, one more than ``max_pairs_per_tile // chunk``, the
early-out on an opaque tile), false or unset the XLA compositor's (blocks
from the tile's first pair, ``max_pairs_per_tile // chunk`` of them, no
early-out). The two differ in tiles that overflow ``max_pairs_per_tile``
and in tiles the early-out cuts. ``pallas_inner`` selects nothing here (the
TPU kernels' sub-block size); it is accepted so the JAX package's configs
load unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from goliath_torch.ops import gsplat_cuda
from goliath_torch.ops.binning import bin_to_tiles
from goliath_torch.ops.gsplat_cuda import ALPHA_CLIP, ALPHA_MIN


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------


def project_gaussians(
    means3d: torch.Tensor,   # [N, 3]
    scales: torch.Tensor,    # [N, 3]
    quats: torch.Tensor,     # [N, 4] (x, y, z, w)
    Rt: torch.Tensor,        # [3or4, 4] world->cam
    fx, fy, cx, cy,
    img_h: int, img_w: int,
    z_near: float = 0.1,
    global_scale: float = 1.0,
    blur: float = 0.3,
) -> Dict[str, torch.Tensor]:
    # channel-wise 3x3 algebra, written as in the JAX reference
    R_wc = Rt[:3, :3]
    t_wc = Rt[:3, 3]
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    px = R_wc[0, 0] * mx + R_wc[0, 1] * my + R_wc[0, 2] * mz + t_wc[0]
    py = R_wc[1, 0] * mx + R_wc[1, 1] * my + R_wc[1, 2] * mz + t_wc[1]
    z = R_wc[2, 0] * mx + R_wc[2, 1] * my + R_wc[2, 2] * mz + t_wc[2]
    depths = z

    qx, qy, qz, qw = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0 = (scales[:, 0] * global_scale) ** 2
    s1 = (scales[:, 1] * global_scale) ** 2
    s2 = (scales[:, 2] * global_scale) ** 2
    # cov3d = R diag(s^2) R^T, 6 unique entries
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2

    zc = z.clamp(min=1e-6)
    # limit the EWA Jacobian evaluation point like gsplat (tan fov * 1.3)
    lim_x = 1.3 * (0.5 * img_w / fx)
    lim_y = 1.3 * (0.5 * img_h / fy)
    tx = zc * torch.clamp(px / zc, -lim_x, lim_x)
    ty = zc * torch.clamp(py / zc, -lim_y, lim_y)
    j00 = fx / zc
    j02 = -fx * tx / zc**2
    j11 = fy / zc
    j12 = -fy * ty / zc**2
    t0x = j00 * R_wc[0, 0] + j02 * R_wc[2, 0]
    t0y = j00 * R_wc[0, 1] + j02 * R_wc[2, 1]
    t0z = j00 * R_wc[0, 2] + j02 * R_wc[2, 2]
    t1x = j11 * R_wc[1, 0] + j12 * R_wc[2, 0]
    t1y = j11 * R_wc[1, 1] + j12 * R_wc[2, 1]
    t1z = j11 * R_wc[1, 2] + j12 * R_wc[2, 2]
    u0x = t0x * c00 + t0y * c01 + t0z * c02
    u0y = t0x * c01 + t0y * c11 + t0z * c12
    u0z = t0x * c02 + t0y * c12 + t0z * c22
    u1x = t1x * c00 + t1y * c01 + t1z * c02
    u1y = t1x * c01 + t1y * c11 + t1z * c12
    u1z = t1x * c02 + t1y * c12 + t1z * c22
    v00 = u0x * t0x + u0y * t0y + u0z * t0z
    v01 = u0x * t1x + u0y * t1y + u0z * t1z
    v11 = u1x * t1x + u1y * t1y + u1z * t1z

    det_raw = v00 * v11 - v01 * v01
    v00 = v00 + blur
    v11 = v11 + blur
    det = v00 * v11 - v01 * v01
    compensation = torch.sqrt(
        (det_raw / det.clamp(min=1e-12)).clamp(min=0.0))

    inv_det = 1.0 / det.clamp(min=1e-12)
    conics = torch.stack([v11 * inv_det, -v01 * inv_det, v00 * inv_det], -1)

    b_ = 0.5 * (v00 + v11)
    v1 = b_ + torch.sqrt((b_**2 - det).clamp(min=0.1))
    radii = torch.ceil(3.0 * torch.sqrt(v1.clamp(min=0.0)))
    # per-axis extents of the 3-sigma ellipse: +-3*sqrt(cov2d_ii)
    radii_x = torch.ceil(3.0 * torch.sqrt(v00.clamp(min=0.0)))
    radii_y = torch.ceil(3.0 * torch.sqrt(v11.clamp(min=0.0)))

    xys = torch.stack([fx * px / zc + cx, fy * py / zc + cy], dim=-1)

    valid = (z > z_near) & (det > 0)
    radii = torch.where(valid, radii, 0.0)
    radii_xy = torch.stack([torch.where(valid, radii_x, 0.0),
                            torch.where(valid, radii_y, 0.0)], dim=-1)
    cov3d = torch.stack([c00, c01, c02, c11, c12, c22], -1)
    return dict(
        xys=xys, depths=depths, radii=radii, radii_xy=radii_xy,
        conics=conics, compensation=compensation, valid=valid, cov3d=cov3d,
    )


# ---------------------------------------------------------------------------
# exact reference compositing (parity oracle)
# ---------------------------------------------------------------------------


def rasterize_reference(
    xys, conics, opacities, colors, depths, valid, img_h: int, img_w: int,
    bg_color: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(H*W*N) exact front-to-back compositing. Use only on small inputs."""
    order = torch.argsort(depths)
    xys = xys[order]
    conics = conics[order]
    op = opacities[order].reshape(-1)
    col = colors[order]
    val = valid[order]

    dev = xys.device
    ys = torch.arange(img_h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(img_w, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([px, py], -1).reshape(-1, 2)  # [P, 2]

    d = xys[:, None, :] - pix[None, :, :]  # [N, P, 2]
    a, b, c = conics[:, 0:1], conics[:, 1:2], conics[:, 2:3]
    sigma = 0.5 * (a * d[..., 0] ** 2 + c * d[..., 1] ** 2) \
        + b * d[..., 0] * d[..., 1]
    alpha = torch.clamp(op[:, None] * torch.exp(-sigma), max=ALPHA_CLIP)
    alpha = torch.where(
        (sigma >= 0) & (alpha >= ALPHA_MIN) & val[:, None], alpha, 0.0)
    one_m = 1.0 - alpha
    T_excl = torch.cumprod(one_m, dim=0) / one_m  # T before each gaussian
    w = alpha * T_excl  # [N, P]
    out = torch.einsum("np,nc->cp", w, col)
    T_final = torch.prod(one_m, dim=0)
    if bg_color is not None:
        out = out + T_final[None] * bg_color[:, None]
    C = colors.shape[-1]
    return out.reshape(C, img_h, img_w), T_final.reshape(img_h, img_w)


# ---------------------------------------------------------------------------
# per-prim reduction of the compositor backward's per-pair gradients
# ---------------------------------------------------------------------------


def reduce_sorted_pair_grads(sorted_g: torch.Tensor, perm: torch.Tensor,
                             prim_offsets: torch.Tensor,
                             prim_ends: torch.Tensor) -> torch.Tensor:
    """Per-pair gradients in sorted-pair order [budget, F] -> per-prim sums,
    channel-first [F, N], without a scatter-add (the JAX package's
    ops/gsplat.py:339-376, its scan branch).

    ``perm[s]`` is the pre-sort slot of sorted pair ``s``, a true
    permutation of [0, budget) (the index output of the binning's sort), so
    one indexed store puts the rows into pre-sort order, where each prim's
    pairs are contiguous (the JAX package sorts with the columns as
    payloads to the same end). K3 takes the F prefix sums, and a prim's sum
    is the difference of the prefix at its two slot bounds (0 where the
    bound is 0). The differences cancel float32 prefixes over the whole
    budget, as in the JAX package."""
    budget, F = sorted_g.shape
    presort = sorted_g.new_empty(F, budget)
    presort.index_copy_(1, perm.long(), sorted_g.T)
    csum = gsplat_cuda.cumsum_cols(presort)                    # [F, budget]
    bounds = torch.cat([prim_offsets, prim_ends[-1:]]).long()  # [N + 1]
    bvals = torch.where((bounds > 0)[None],
                        csum[:, (bounds - 1).clamp(0, budget - 1)], 0.0)
    return bvals[:, 1:] - bvals[:, :-1]


def reduce_presort_pair_grads(presort_g: torch.Tensor,
                              prim_offsets: torch.Tensor,
                              prim_ends: torch.Tensor) -> torch.Tensor:
    """Per-prim sums [N, F] of pair gradients in PRE-SORT order [budget, F]
    (each prim's pairs contiguous; the JAX package's ops/gsplat.py:381-398):
    the axis-0 prefix sum (K7 on CUDA tensors), read at the N + 1 slot
    bounds, differenced. ``reduce_sorted_pair_grads`` takes the
    channel-first route on K3 instead, as the JAX package does on the TPU,
    so the render path does not reach this function; the JAX package calls
    it off the TPU, and scripts/profile_reduce.py times it."""
    budget = presort_g.shape[0]
    csum = gsplat_cuda.cumsum_rows(presort_g.float())          # [budget, F]
    bounds = torch.cat([prim_offsets, prim_ends[-1:]]).long()  # [N + 1]
    bvals = torch.where((bounds > 0)[:, None],
                        csum[(bounds - 1).clamp(0, budget - 1)], 0.0)
    return bvals[1:] - bvals[:-1]


# ---------------------------------------------------------------------------
# full render (batched)
# ---------------------------------------------------------------------------


def prepare_sample(
    K_b, Rt_b, pos, quat, scale, op, col,
    cam_img_h: int, cam_img_w: int, tile_size: int,
    z_near: float = 0.1, global_scale: float = 1.0,
    max_tiles_per_prim: int = 64, pair_budget: int | None = None,
    return_depth: bool = True,
    y_offset_px: float = 0.0,
    bin_img_h: int | None = None,
):
    """Project one sample's gaussians and bin them to screen tiles.

    Returns (xys, conics, op_s, chan, valid, radii, binning). Per-tile
    depth order comes from the composite (tile << bits | quantized log
    depth) sort key inside the binning; there is no global depth sort.

    ``y_offset_px`` moves the projected centers up by that many rows (after
    projection: conics do not change under a translation) and
    ``bin_img_h`` cuts the tile grid, and so the depth bits, to that
    height, so that a caller renders a horizontal band of the image as if
    it were a small image (parallel/tile_shard.py). Projection (the
    Jacobian's limits, validity, the depth range) always uses the full
    ``cam_img_h``, so per-prim quantities are the same in every band."""
    ntx = -(-cam_img_w // tile_size)
    nty = -(-(bin_img_h if bin_img_h is not None else cam_img_h)
            // tile_size)
    N = pos.shape[0]
    if pair_budget is None:
        pair_budget = 4 * N
    (xys, conics, op_s, chan, valid, radii, ld,
     t_min, t_max) = _project_sample(
        K_b, Rt_b, pos, quat, scale, op, col, cam_img_h, cam_img_w,
        tile_size, z_near, global_scale, return_depth, y_offset_px)

    num_tiles = ntx * nty
    dbits = 31 - int(num_tiles + 1).bit_length()
    qd = _quantize_log_depth(ld, valid, dbits)
    binning = bin_to_tiles(
        t_min, t_max, valid & (radii > 0), ntx, nty,
        max_tiles_per_prim, pair_budget, depth_keys=qd,
    )
    return xys, conics, op_s, chan, valid, radii, binning


def _project_sample(K_b, Rt_b, pos, quat, scale, op, col, cam_img_h,
                    cam_img_w, tile_size, z_near, global_scale,
                    return_depth, y_offset_px=0.0):
    """Per-prim projection half of prepare_sample.

    Returns (xys, conics, op_s, chan, valid, radii, log_depth, t_min,
    t_max); the tile AABBs are unclipped (bin_to_tiles clips). The centers
    are moved up by ``y_offset_px`` rows before the AABBs."""
    proj = project_gaussians(
        pos, scale, quat, Rt_b,
        K_b[0, 0], K_b[1, 1], K_b[0, 2], K_b[1, 2],
        cam_img_h, cam_img_w, z_near, global_scale,
    )
    xys = proj["xys"]
    if y_offset_px:
        xys = xys - xys.new_tensor([0.0, float(y_offset_px)])
    conics = proj["conics"]
    radii = proj["radii"]
    op_s = (op.reshape(-1) * proj["compensation"])[:, None]
    depth_s = proj["depths"]
    valid = proj["valid"]
    # opacity-aware footprint: alpha = op*exp(-sigma) >= 1/255 iff
    # sigma <= ln(255*op), so the exact support is sqrt(2 ln(255 op)) sigmas,
    # capped at the 3-sigma box
    fac = torch.sqrt(
        (2.0 * torch.log((255.0 * op_s[:, 0]).clamp(min=1e-12))).clamp(0.0, 9.0)
    ) * (1.0 / 3.0)
    rx = proj["radii_xy"][:, 0] * fac
    ry = proj["radii_xy"][:, 1] * fac
    valid = valid & (fac > 0)
    chan = col
    if return_depth:
        chan = torch.cat([chan, depth_s[:, None]], dim=-1)

    ld = torch.log(depth_s.clamp(min=z_near))
    t_min = torch.stack(
        [torch.floor((xys[:, 0] - rx) / tile_size),
         torch.floor((xys[:, 1] - ry) / tile_size)], -1
    ).to(torch.int32)
    t_max = torch.stack(
        [torch.floor((xys[:, 0] + rx) / tile_size) + 1,
         torch.floor((xys[:, 1] + ry) / tile_size) + 1], -1
    ).to(torch.int32)
    return xys, conics, op_s, chan, valid, radii, ld, t_min, t_max


def _quantize_log_depth(ld, valid, dbits):
    """Quantize log depth to dbits levels over the VALID range (log space
    keeps relative resolution when one far outlier stretches the range)."""
    dmin = torch.where(valid, ld, torch.inf).min()
    dmax = torch.where(valid, ld, -torch.inf).max()
    dspan = (dmax - dmin).clamp(min=1e-9)
    return torch.clamp(
        (ld - dmin) / dspan * ((1 << dbits) - 1), 0, (1 << dbits) - 1,
    ).to(torch.int32)


def _render_folded(cam_img_w, cam_img_h, K, Rt, primpos, primqvec,
                   primscale, opacity, colors, return_depth, tile_size,
                   global_scale, z_near, max_tiles_per_prim,
                   max_pairs_per_tile, chunk, pair_budget_mult, ntx, nty):
    """Batch-folded render (the JAX package's ops/gsplat.py:630-686): the B
    images stacked VERTICALLY in tile space, all B*N prims binned by ONE
    ``bin_to_tiles`` over the ntx x (B*nty) grid, and one compositor
    launch (K6) and one backward reduce for the whole batch.

    As in the JAX package: the depth bits come from the global tile count
    (17 at full width and B = 4, where the per-sample path has 19), each
    sample's log depth is quantized over its own valid range, each sample's
    tile box is clipped to its own image before it moves down by b*nty
    rows, and the pair budget is GLOBAL (B * round(pair_budget_mult * N)):
    under overflow the later-stacked samples lose pairs first, where the
    per-sample path drops each sample's own farthest pairs. Returns
    (out [B, C, H, W], T_final [B, H, W])."""
    B, N = primpos.shape[:2]
    budget_total = int(round(pair_budget_mult * N)) * B
    proj = [_project_sample(K[b], Rt[b], primpos[b], primqvec[b],
                            primscale[b], opacity[b], colors[b], cam_img_h,
                            cam_img_w, tile_size, z_near, global_scale,
                            return_depth) for b in range(B)]
    xys, conics, op_s, chan, valid, radii, ld, t_min, t_max = (
        torch.stack(x) for x in zip(*proj))

    num_tiles_g = ntx * nty * B
    dbits = 31 - int(num_tiles_g + 1).bit_length()
    qd = torch.stack([_quantize_log_depth(ld[b], valid[b], dbits)
                      for b in range(B)])

    # per-sample clip, then offset each sample's tile rows by b*nty
    yoff = (torch.arange(B, dtype=torch.int32, device=t_min.device)
            * nty)[:, None]
    tmin_f = torch.stack(
        [t_min[..., 0].clamp(0, ntx).reshape(-1),
         (t_min[..., 1].clamp(0, nty) + yoff).reshape(-1)], -1)
    tmax_f = torch.stack(
        [t_max[..., 0].clamp(0, ntx).reshape(-1),
         (t_max[..., 1].clamp(0, nty) + yoff).reshape(-1)], -1)
    valid_f = (valid & (radii > 0)).reshape(-1)

    binning = bin_to_tiles(tmin_f, tmax_f, valid_f, ntx, nty * B,
                           max_tiles_per_prim, budget_total,
                           depth_keys=qd.reshape(-1))
    return gsplat_cuda.rasterize_tiled(
        xys.reshape(B * N, 2), conics.reshape(B * N, 3),
        op_s.reshape(B * N, 1), chan.reshape(B * N, chan.shape[-1]),
        valid_f, binning.sorted_prim, binning.tile_start, binning.tile_end,
        binning.perm, binning.prim_offsets, binning.prim_ends, cam_img_h,
        cam_img_w, tile_size, max_pairs_per_tile, chunk, ntx, nty,
        window="pallas", n_imgs=B)


def render(
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
    tile_size: int = 16,
    global_scale: float = 1.0,
    z_near: float = 0.1,
    max_tiles_per_prim: int = 64,
    max_pairs_per_tile: int = 512,
    chunk: int = 64,
    pair_budget_mult: float = 4,
    use_pallas: bool = False,
    pallas_inner: int = 256,
    return_radii: bool = False,
    tile_shard_mesh=None,
    tile_shard_axis: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Batched gaussian-splat render, differentiable with respect to
    primpos, primqvec, primscale, opacity and colors.

    Returns dict(render [B,3,H,W], final_T [B,1,H,W], alpha [B,1,H,W],
    depth [B,1,H,W] if return_depth, radii [B,N] if return_radii).
    ``use_pallas`` selects the compositor's block window and, with
    ``GOLIATH_GSPLAT_FOLD=1``, the batch-folded path; ``pallas_inner`` is
    accepted for config compatibility and selects nothing (see the module
    docstring).

    With ``tile_shard_axis`` set, the screen's tile rows are split in bands
    over that axis of ``tile_shard_mesh``
    (``parallel.tile_shard.render_tile_sharded``; the fold does not apply
    there). ``return_radii`` is refused on that route, as in the JAX
    package."""
    if tile_shard_axis is not None:
        from goliath_torch.parallel.tile_shard import render_tile_sharded

        if return_radii:
            raise ValueError("return_radii is not supported by the "
                             "tile-sharded render (tile_shard_axis)")
        return render_tile_sharded(
            tile_shard_mesh, tile_shard_axis, cam_img_w, cam_img_h,
            K, Rt, primpos, primqvec, primscale, opacity, colors,
            return_depth=return_depth, bg_color=bg_color,
            tile_size=tile_size, global_scale=global_scale, z_near=z_near,
            max_tiles_per_prim=max_tiles_per_prim,
            max_pairs_per_tile=max_pairs_per_tile, chunk=chunk,
            pair_budget_mult=pair_budget_mult, use_pallas=use_pallas,
            pallas_inner=pallas_inner,
        )
    del pallas_inner
    ntx = -(-cam_img_w // tile_size)
    nty = -(-cam_img_h // tile_size)
    B, N = primpos.shape[:2]

    radii_all = []
    if (use_pallas and os.environ.get("GOLIATH_GSPLAT_FOLD", "0") == "1"
            and B > 1 and not return_radii):
        out, T_final = _render_folded(
            cam_img_w, cam_img_h, K, Rt, primpos, primqvec, primscale,
            opacity, colors, return_depth, tile_size, global_scale, z_near,
            max_tiles_per_prim, max_pairs_per_tile, chunk, pair_budget_mult,
            ntx, nty)
    else:
        budget = int(round(pair_budget_mult * N))
        window = "pallas" if use_pallas else "xla"
        outs, Ts = [], []
        for b in range(B):  # per sample, as the JAX Pallas path unrolls it
            xys, conics, op_s, chan, valid, radii, binning = prepare_sample(
                K[b], Rt[b], primpos[b], primqvec[b], primscale[b],
                opacity[b], colors[b], cam_img_h, cam_img_w, tile_size,
                z_near, global_scale, max_tiles_per_prim, budget,
                return_depth,
            )
            out, T_final = gsplat_cuda.rasterize_tiled(
                xys, conics, op_s, chan, valid, binning.sorted_prim,
                binning.tile_start, binning.tile_end, binning.perm,
                binning.prim_offsets, binning.prim_ends, cam_img_h,
                cam_img_w, tile_size, max_pairs_per_tile, chunk, ntx, nty,
                window=window,
            )
            outs.append(out)
            Ts.append(T_final)
            radii_all.append(radii)
        out = torch.stack(outs)
        T_final = torch.stack(Ts)
    rgb = out[:, :3]
    alpha = (1.0 - T_final)[:, None]
    if bg_color is not None:
        rgb = rgb + T_final[:, None] * bg_color[None, :, None, None]
    result = {
        "render": rgb,
        "final_T": T_final[:, None],
        "alpha": alpha,
    }
    if return_radii:
        result["radii"] = torch.stack(radii_all)
    if return_depth:
        result["depth"] = out[:, 3:4]
    return result

