"""Hand-written CUDA kernels of the splat path, their plain versions, and
the build and binding code of all the port's kernels (counterpart of the
JAX package's ops/gsplat_pallas.py).

Kernels (sources in ``ops/csrc/``; the mesh z-buffer K5 of
``ops/rasterizer_cuda.py`` among them) are built at first use into one
extension module with ``torch.utils.cpp_extension.load``: nvcc compiles each
``.cu`` for ``sm_90a`` and the host compiler ``csrc/bindings.cpp``, whose
bindings check their tensors and launch on the current stream. The build
goes to ``build/kernels/`` at the repo root and is reused while the sources
are unchanged.

* K1 ``compositor_fwd`` (``csrc/compositor_fwd.cu``) replaces
  ``_compositor_kernel`` / ``rasterize_tiled_pallas_fwd``. Plain version:
  ``compositor_fwd_plain``, the forward of ``_rasterize_fwd_impl``
  (the JAX package's ops/gsplat.py:266-336) run over the Pallas kernel's
  chunk-aligned block window with its early-out and block count.
* K2 ``pair_grads`` (``csrc/compositor_bwd.cu``) replaces
  ``_compositor_bwd_kernel`` / ``pair_grads_pallas``. Plain version:
  ``pair_grads_plain``, the same front-to-back replay in PyTorch.
* K3 ``cumsum_cols`` (``csrc/cumsum.cu``) replaces
  ``_cumsum1d_batched_kernel`` / ``cumsum_cols_pl``. Plain version:
  ``torch.cumsum(x, dim=1)`` in float32.
* K4 ``cumsum1d`` (``csrc/cumsum.cu``) replaces ``_cumsum1d_kernel`` /
  ``cumsum1d_pl``. Plain version: ``torch.cumsum(dtype=int32)``.
* ``RasterizeTiled`` joins K1 and K2 (with the per-prim reduce of
  ops/gsplat.py on K3) into one differentiable function, the counterpart of
  ``rasterize_tiled_pl``.

Each wrapper takes the kernel for a CUDA tensor and the plain version for a
CPU tensor (ops/backend.py), and adds one to ``LAUNCHES[name]`` each time it
launches its kernel. Nothing here builds or loads a kernel at import time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from goliath_torch.ops.backend import target_backend

ALPHA_CLIP = 0.999
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
MAX_CHANNELS = 8  # MAX_C in csrc/splat_alpha.cuh
PAIR_GRAD_COLS = 16  # dx, dy, d(conic) x3, d(opacity), d(color) x C, 0 pad
# elements of the plain compositors' [tiles, chunk, pixels] temporaries
PLAIN_BATCH_ELEMS = 1 << 24

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3"]
SOURCES = {"compositor_fwd": "compositor_fwd.cu",
           "pair_grads": "compositor_bwd.cu",
           "cumsum_cols": "cumsum.cu",
           "cumsum1d": "cumsum.cu",
           "zbuffer": "zbuffer.cu"}
REPLACES = {
    "compositor_fwd": "ops/gsplat_pallas.py:245",
    "pair_grads": "ops/gsplat_pallas.py:471",
    "cumsum_cols": "ops/gsplat_pallas.py:169",
    "cumsum1d": "ops/gsplat_pallas.py:110",
    "zbuffer": "ops/rasterizer_pallas.py:28",
}

# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_EXT = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels():
    """Build (or reuse the build of) the kernels' extension module and
    import it. Raises with the compiler's output when the build fails."""
    global _EXT
    if _EXT is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _EXT = load(name="goliath_kernels",
                    sources=[str(_CSRC / "bindings.cpp")]
                    + [str(_CSRC / src)
                       for src in sorted(set(SOURCES.values()))],
                    extra_cflags=["-O3"], extra_cuda_cflags=NVCC_FLAGS,
                    build_directory=str(BUILD_DIR))
    return _EXT


# ---------------------------------------------------------------------------
# K4: inclusive int32 prefix sum
# ---------------------------------------------------------------------------


def cumsum1d_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def cumsum1d(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1-D prefix sum of an int32 vector (K4 on CUDA tensors).

    The carry is integer, so unlike the TPU kernel (f32 carry, exact below
    2^24) it equals ``torch.cumsum`` bit for bit at any total."""
    if x.dim() != 1 or x.dtype != torch.int32:
        raise ValueError(f"cumsum1d takes a 1-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if target_backend(x) == "cpu":
        return cumsum1d_plain(x)
    out = load_kernels().cumsum_i32(x.contiguous())
    LAUNCHES["cumsum1d"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: inclusive float32 prefix sums of the rows of [F, M]
# ---------------------------------------------------------------------------


def cumsum_cols_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1, dtype=torch.float32)


def cumsum_cols(x: torch.Tensor) -> torch.Tensor:
    """F independent inclusive prefix sums along dim 1 of a [F, M] float32
    tensor (K3 on CUDA tensors).

    Float addition is not associative: the kernel adds in its scan tree's
    order and ``torch.cumsum`` in its own, so the two agree to a few ulp of
    each row's largest running sum, not bit for bit."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"cumsum_cols takes a [F, M] float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if target_backend(x) == "cpu":
        return cumsum_cols_plain(x)
    out = load_kernels().cumsum_cols_f32(x.contiguous())
    LAUNCHES["cumsum_cols"] += 1
    return out


# ---------------------------------------------------------------------------
# K1: tile compositor forward
# ---------------------------------------------------------------------------


def pack_pair_rows(xys, conics, opacities, colors, valid, sorted_prim,
                   pad_rows: int) -> torch.Tensor:
    """Pair rows [budget + pad_rows, 8 + C] in sorted-pair order
    (gsplat_pallas.py:339-359): x, y, conic a/b/c, opacity*valid, 0, 0,
    colors. The CUDA kernel bounds its reads by each tile's end and needs
    no pad; the plain version reads whole blocks and does."""
    N = xys.shape[0]
    gi = sorted_prim.clamp(0, N - 1).long()
    src = torch.cat(
        [xys, conics, (opacities.reshape(-1) * valid)[:, None],
         xys.new_zeros(N, 2), colors], dim=1)
    return F.pad(src[gi], (0, 0, 0, pad_rows))


def _tiles_to_image(tiles_cp, ntx, nty, ts, img_h, img_w):
    """[T, C, P] -> [C, H, W], cropped to the image."""
    T, C, P = tiles_cp.shape
    x = tiles_cp.reshape(nty, ntx, C, ts, ts).permute(2, 0, 3, 1, 4)
    return x.reshape(C, nty * ts, ntx * ts)[:, :img_h, :img_w]


def compositor_fwd_plain(rows, tile_start, tile_end, img_h: int, img_w: int,
                         tile_size: int, ntx: int, nty: int, chunk: int,
                         max_pairs_per_tile: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``_rasterize_fwd_impl``'s per-chunk cumprod
    compositing over the Pallas kernel's window (block j of a tile covers
    rows [(start//chunk + j)*chunk, +chunk) masked to [start, end), for
    j < max_pairs_per_tile//chunk + 1), with its early-out (a block is
    skipped once the tile's max T <= 1e-4) and its block count ``cnt``.

    Tiles run in batches to bound the [tiles, chunk, pixels] temporaries
    to ``PLAIN_BATCH_ELEMS`` elements. Returns (color [C, H, W], T [H, W], cnt [tiles])."""
    C = rows.shape[1] - 8
    P = tile_size * tile_size
    n_tiles = ntx * nty
    nchunks = max_pairs_per_tile // chunk + 1
    tile_batch = max(1, PLAIN_BATCH_ELEMS // (chunk * P))
    dev = rows.device
    pix = torch.arange(P, device=dev)
    px_local = (pix % tile_size).float() + 0.5
    py_local = (pix // tile_size).float() + 0.5
    lane = torch.arange(chunk, device=dev)
    last_row = rows.shape[0] - 1
    accs, Ts, cnts = [], [], []
    for t0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        start = tile_start[tiles].long()
        end = tile_end[tiles].long()
        px = ((tiles % ntx) * tile_size).float()[:, None] + px_local
        py = ((tiles // ntx) * tile_size).float()[:, None] + py_local
        T = torch.ones(len(tiles), P, device=dev)
        acc = torch.zeros(len(tiles), C, P, device=dev)
        cnt = torch.zeros(len(tiles), dtype=torch.int32, device=dev)
        for j in range(nchunks):
            base = (start // chunk + j) * chunk
            have = (base < end) & (base + chunk > start) \
                & (T.amax(dim=1) > T_EPS)
            cnt = torch.where(have, j + 1, cnt)
            idx = base[:, None] + lane                          # [n, CH]
            m = (idx >= start[:, None]) & (idx < end[:, None]) & have[:, None]
            data = rows[idx.clamp(max=last_row)]                # [n, CH, F]
            dx = data[..., 0, None] - px[:, None]               # [n, CH, P]
            dy = data[..., 1, None] - py[:, None]
            a, b, c = (data[..., k, None] for k in (2, 3, 4))
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            raw = data[..., 5, None] * torch.exp(-sigma.clamp(0.0, 60.0))
            alpha = raw.clamp(max=ALPHA_CLIP)
            keep = (sigma >= 0) & (alpha >= ALPHA_MIN) & m[..., None]
            alpha = torch.where(keep, alpha, 0.0)
            one_m = 1.0 - alpha
            cum = torch.cumprod(one_m, dim=1)
            w = alpha * (T[:, None] * cum / one_m)
            acc = acc + torch.einsum("nkp,nkc->ncp", w, data[..., 8:])
            T = T * cum[:, -1]
        accs.append(acc)
        Ts.append(T)
        cnts.append(cnt)
    acc, T, cnt = torch.cat(accs), torch.cat(Ts), torch.cat(cnts)
    img = _tiles_to_image(acc, ntx, nty, tile_size, img_h, img_w)
    T_img = _tiles_to_image(T[:, None], ntx, nty, tile_size, img_h, img_w)[0]
    return img, T_img, cnt


def compositor_fwd(rows, tile_start, tile_end, img_h: int, img_w: int,
                   tile_size: int, ntx: int, nty: int, chunk: int,
                   max_pairs_per_tile: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, ``compositor_fwd_plain`` on CPU tensors.

    rows: [R, 8 + C] f32 from ``pack_pair_rows``; tile_start/tile_end:
    [ntx * nty] int32 with 0 <= start <= end <= R (bin_to_tiles guarantees
    this: both come from a searchsorted into the pair buffer). Returns
    (color [C, H, W], T [H, W], cnt [tiles] int32)."""
    n_tiles = ntx * nty
    C = rows.shape[1] - 8
    if rows.dim() != 2 or rows.dtype != torch.float32 or C < 1:
        raise ValueError(f"rows must be [R, 8 + C] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    for t in (tile_start, tile_end):
        if t.shape != (n_tiles,) or t.dtype != torch.int32:
            raise ValueError(f"tile bounds must be [{n_tiles}] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if target_backend(rows) == "cpu":
        return compositor_fwd_plain(rows, tile_start, tile_end, img_h, img_w,
                                    tile_size, ntx, nty, chunk,
                                    max_pairs_per_tile)
    if C > MAX_CHANNELS or tile_size * tile_size > 1024:
        raise ValueError(f"K1 takes at most {MAX_CHANNELS} channels and "
                         f"32x32 tiles, got C={C}, tile {tile_size}")
    img, T, cnt = load_kernels().compositor_fwd(
        rows.contiguous(), tile_start.contiguous(), tile_end.contiguous(),
        ntx, tile_size, img_h, img_w, chunk, max_pairs_per_tile // chunk + 1)
    LAUNCHES["compositor_fwd"] += 1
    return img, T, cnt


# ---------------------------------------------------------------------------
# K2: tile compositor backward (per-pair gradients)
# ---------------------------------------------------------------------------


def _image_to_tiles(img, ntx, nty, ts):
    """[K, H, W] -> [T, K, P], zero padded to whole tiles."""
    K, H, W = img.shape
    x = F.pad(img, (0, ntx * ts - W, 0, nty * ts - H))
    x = x.reshape(K, nty, ts, ntx, ts).permute(1, 3, 0, 2, 4)
    return x.reshape(nty * ntx, K, ts * ts)


def pair_grads_plain(rows, tile_start, tile_end, cnt, dL_dout, dL_dT,
                     T_final, out_img, tile_size: int, ntx: int, nty: int,
                     chunk: int, n_pairs: int,
                     counts: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch K2: per-pair gradients [n_pairs, 16] in sorted-pair
    order (dx, dy, d conic a/b/c, d opacity, d color x C, zero pad).

    Replays ``compositor_fwd_plain`` front to back over the blocks
    ``j < cnt[t]`` of each tile with the suffix-from-total identity
    ``R_i = (dT*Tf + dout.out) - prefix_i(w q)`` and the same formulas as
    ``_compositor_bwd_kernel`` (gsplat_pallas.py:551-613). That kernel also
    clamps the in-block transmittance factor at 1e-20 (its log-space
    prefix's ``_LOG_CLIP``); factors that small scale terms far below the
    float32 resolution of the sums they enter, and neither this version nor
    the CUDA kernel applies the clamp. Rows no block reaches stay zero.

    ``counts``, if given, receives under "kept" the number of (pair, pixel)
    evaluations inside the image that pass the alpha test (an int64 tensor):
    the only ones whose gradient terms are not zero by definition."""
    C = rows.shape[1] - 8
    P = tile_size * tile_size
    n_tiles = ntx * nty
    tile_batch = max(1, PLAIN_BATCH_ELEMS // (chunk * P))
    dev = rows.device
    pix = torch.arange(P, device=dev)
    px_local = (pix % tile_size).float() + 0.5
    py_local = (pix // tile_size).float() + 0.5
    lane = torch.arange(chunk, device=dev)
    last_row = rows.shape[0] - 1
    planes = _image_to_tiles(
        torch.cat([dL_dout, dL_dT[None], T_final[None], out_img]),
        ntx, nty, tile_size)                                   # [T, 2C+2, P]
    grads = rows.new_zeros(n_pairs, PAIR_GRAD_COLS)
    pad = rows.new_zeros(PAIR_GRAD_COLS - 6 - C)
    img_h, img_w = T_final.shape
    for t0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        start = tile_start[tiles].long()
        end = tile_end[tiles].long()
        n_blocks = cnt[tiles]
        px = ((tiles % ntx) * tile_size).float()[:, None] + px_local
        py = ((tiles // ntx) * tile_size).float()[:, None] + py_local
        dout = planes[tiles, :C]                                # [n, C, P]
        R0 = planes[tiles, C] * planes[tiles, C + 1] \
            + (dout * planes[tiles, C + 2:]).sum(dim=1)         # [n, P]
        T = torch.ones(len(tiles), P, device=dev)
        Pq = torch.zeros(len(tiles), P, device=dev)
        for j in range(int(n_blocks.max()) if len(tiles) else 0):
            base = (start // chunk + j) * chunk
            have = (base < end) & (base + chunk > start) & (j < n_blocks)
            idx = base[:, None] + lane                          # [n, CH]
            m = (idx >= start[:, None]) & (idx < end[:, None]) & have[:, None]
            data = rows[idx.clamp(max=last_row)]                # [n, CH, F]
            dx = data[..., 0, None] - px[:, None]               # [n, CH, P]
            dy = data[..., 1, None] - py[:, None]
            a, b, c, op = (data[..., k] for k in (2, 3, 4, 5))  # [n, CH]
            sigma = 0.5 * (a[..., None] * dx * dx + c[..., None] * dy * dy) \
                + b[..., None] * dx * dy
            raw = op[..., None] * torch.exp(-sigma.clamp(0.0, 60.0))
            alpha = raw.clamp(max=ALPHA_CLIP)
            keep = (sigma >= 0) & (alpha >= ALPHA_MIN) & m[..., None]
            alpha = torch.where(keep, alpha, 0.0)
            if counts is not None:
                inside = (px < img_w) & (py < img_h)            # [n, P]
                counts["kept"] = counts.get("kept", 0) \
                    + (keep & inside[:, None]).sum()
            one_m = 1.0 - alpha
            cum = torch.cumprod(one_m, dim=1)
            T_i = T[:, None] * cum / one_m                      # T before i
            w = alpha * T_i
            q = torch.einsum("nkc,ncp->nkp", data[..., 8:], dout)
            wq = w * q
            R_i = R0[:, None] - (Pq[:, None] + torch.cumsum(wq, dim=1))
            dalpha = torch.where(
                keep, q * T_i - R_i / one_m.clamp(min=1e-3), 0.0)
            draw = torch.where(raw < ALPHA_CLIP, dalpha, 0.0)
            dsigma = torch.where(keep, -raw * draw, 0.0)        # [n, CH, P]
            t0_ = dx * dsigma
            t1_ = dy * dsigma
            ga = 0.5 * (dx * t0_).sum(-1)
            gb = (dy * t0_).sum(-1)
            gc = 0.5 * (dy * t1_).sum(-1)
            u = t0_.sum(-1)
            v = t1_.sum(-1)
            dop = torch.where(op > 0,
                              -dsigma.sum(-1) / op.clamp(min=1e-20), 0.0)
            dcol = torch.einsum("nkp,ncp->nkc", w, dout)        # [n, CH, C]
            block = torch.cat(
                [torch.stack([a * u + b * v, b * u + c * v, ga, gb, gc, dop],
                             dim=-1), dcol,
                 pad.expand(dcol.shape[:2] + pad.shape)], dim=-1)
            # every sorted pair lies in one tile's [start, end): the masked
            # rows are distinct, so this is a plain store
            grads[idx[m]] = block[m]
            Pq = Pq + wq.sum(dim=1)
            T = T * cum[:, -1]
    return grads


def pair_grads(rows, tile_start, tile_end, cnt, dL_dout, dL_dT, T_final,
               out_img, tile_size: int, ntx: int, nty: int, chunk: int,
               n_pairs: int) -> torch.Tensor:
    """K2 on CUDA tensors, ``pair_grads_plain`` on CPU tensors.

    rows/tile_start/tile_end as for ``compositor_fwd`` (tile ends within
    ``n_pairs``, the pair budget); cnt [tiles] int32, T_final [H, W] and
    out_img [C, H, W] are the forward's outputs; dL_dout [C, H, W] and dL_dT
    [H, W] the gradients with respect to them. Returns [n_pairs, 16] f32."""
    n_tiles = ntx * nty
    C = rows.shape[1] - 8
    if rows.dim() != 2 or rows.dtype != torch.float32 or C < 1:
        raise ValueError(f"rows must be [R, 8 + C] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    for t in (tile_start, tile_end, cnt):
        if t.shape != (n_tiles,) or t.dtype != torch.int32:
            raise ValueError(f"tile bounds and cnt must be [{n_tiles}] "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    H, W = T_final.shape
    for t, shape in ((dL_dout, (C, H, W)), (out_img, (C, H, W)),
                     (dL_dT, (H, W))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"image planes must be float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if target_backend(rows) == "cpu":
        return pair_grads_plain(rows, tile_start, tile_end, cnt, dL_dout,
                                dL_dT, T_final, out_img, tile_size, ntx, nty,
                                chunk, n_pairs)
    threads = tile_size * tile_size
    if C > MAX_CHANNELS or threads > 1024 or threads % 32:
        raise ValueError(f"K2 takes at most {MAX_CHANNELS} channels and "
                         f"8x8, 16x16 or 32x32 tiles, got C={C}, tile "
                         f"{tile_size}")
    grads = load_kernels().compositor_bwd(
        rows.contiguous(), tile_start.contiguous(), tile_end.contiguous(),
        cnt.contiguous(), dL_dout.contiguous(), dL_dT.contiguous(),
        T_final.contiguous(), out_img.contiguous(), ntx, tile_size, chunk,
        n_pairs)
    LAUNCHES["pair_grads"] += 1
    return grads


# ---------------------------------------------------------------------------
# the differentiable tile compositor
# ---------------------------------------------------------------------------


class RasterizeTiled(torch.autograd.Function):
    """Tiled compositor with its hand-written backward (counterpart of
    ``rasterize_tiled_pl``, gsplat_pallas.py:745-810). The forward packs the
    pair rows and runs K1; it keeps the rows, K1's outputs (the backward
    replays the forward up to ``cnt`` and needs the rendered color and final
    T for its suffix sums) and the binning's permutation and per-prim slot
    ranges. The backward runs K2 and reduces the per-pair gradients to
    per-prim sums on K3 (``ops.gsplat.reduce_sorted_pair_grads``)."""

    @staticmethod
    def forward(ctx, xys, conics, opacities, colors, valid, sorted_prim,
                tile_start, tile_end, perm, prim_offsets, prim_ends,
                img_h, img_w, tile_size, max_pairs_per_tile, chunk, ntx, nty):
        nchunks = max_pairs_per_tile // chunk + 1
        rows = pack_pair_rows(xys, conics, opacities, colors,
                              valid.to(xys.dtype), sorted_prim,
                              nchunks * chunk)
        out, T, cnt = compositor_fwd(rows, tile_start, tile_end, img_h,
                                     img_w, tile_size, ntx, nty, chunk,
                                     max_pairs_per_tile)
        ctx.save_for_backward(rows, out, T, cnt, tile_start, tile_end, perm,
                              prim_offsets, prim_ends)
        ctx.dims = (tile_size, ntx, nty, chunk, sorted_prim.shape[0],
                    colors.shape[1], opacities.shape)
        return out, T

    @staticmethod
    def backward(ctx, d_out, d_T):
        from goliath_torch.ops.gsplat import reduce_sorted_pair_grads

        (rows, out, T, cnt, tile_start, tile_end, perm, prim_offsets,
         prim_ends) = ctx.saved_tensors
        tile_size, ntx, nty, chunk, budget, C, op_shape = ctx.dims
        sorted_g = pair_grads(rows, tile_start, tile_end, cnt, d_out, d_T, T,
                              out, tile_size, ntx, nty, chunk, budget)
        acc = reduce_sorted_pair_grads(sorted_g[:, :6 + C], perm,
                                       prim_offsets, prim_ends)   # [F, N]
        return (acc[0:2].T, acc[2:5].T, acc[5].reshape(op_shape), acc[6:].T,
                ) + (None,) * 14


def rasterize_tiled(xys, conics, opacities, colors, valid, sorted_prim,
                    tile_start, tile_end, perm, prim_offsets, prim_ends,
                    img_h: int, img_w: int, tile_size: int,
                    max_pairs_per_tile: int, chunk: int, ntx: int, nty: int):
    """Tiled splat compositing: ([C, H, W], T [H, W]), differentiable with
    respect to xys [N, 2], conics [N, 3], opacities and colors [N, C]. The
    other tensors are the binning's (``ops.binning.TileBinning``)."""
    return RasterizeTiled.apply(xys, conics, opacities, colors, valid,
                                sorted_prim, tile_start, tile_end, perm,
                                prim_offsets, prim_ends, img_h, img_w,
                                tile_size, max_pairs_per_tile, chunk, ntx,
                                nty)
