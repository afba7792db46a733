"""Hand-written CUDA kernels of the splat path, their plain versions, and
the build and binding code of all the port's kernels (counterpart of the
JAX package's ops/gsplat_pallas.py).

Kernels (sources in ``ops/csrc/``; the mesh z-buffer K5 of
``ops/rasterizer_cuda.py``, the MVP march's forward K8, its backward K10
and the deep-shadow integral K9 of ``ops/mvp_cuda.py`` among them) are built
at first use into one extension module with
``torch.utils.cpp_extension.load``: nvcc compiles each ``.cu`` (with the
headers beside it) for ``sm_90a`` and the host compiler
``csrc/bindings.cpp``, whose
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
* K1 and K2 take a block window: ``"pallas"`` (the TPU kernels' window, as
  above) or ``"xla"`` (the JAX XLA compositor's, ``use_pallas`` false:
  blocks ``[start + j*chunk, +chunk)`` for ``j < max_pairs_per_tile //
  chunk``, no early-out), counted under ``compositor_fwd_xla`` and
  ``pair_grads_xla``.
* K6 is K1 and K2 with an image axis (``n_imgs > 1``): the B images of the
  batch-folded render stacked vertically in tile space, one launch each,
  replacing ``rasterize_tiled_pl_fold`` (``_plf_fwd`` / ``_plf_bwd``);
  counted under ``compositor_fwd_fold`` and ``pair_grads_fold``.
* K3 ``cumsum_cols`` (``csrc/cumsum.cu``) replaces
  ``_cumsum1d_batched_kernel`` / ``cumsum_cols_pl``. Plain version:
  ``torch.cumsum(x, dim=1)`` in float32.
* K4 ``cumsum1d`` (``csrc/cumsum.cu``, a single-pass scan with decoupled
  look-back) replaces ``_cumsum1d_kernel`` / ``cumsum1d_pl``. Plain
  version: ``torch.cumsum(dtype=int32)``.
* K7 ``cumsum_rows`` (``csrc/cumsum.cu``, a single-pass scan of the
  columns of a row-major [M, F], tiles of whole rows summed in float64,
  K3's float64 carry per column) replaces ``_cumsum_rows_kernel`` / ``cumsum_rows_pl``.
  Plain version: ``torch.cumsum(x.float(), 0)``.
* P1 ``probe_fwd`` (``csrc/compositor_fwd.cu``, compile-time variants of
  K1) replaces the kernel variants of scripts/probe_kernel.py. Plain
  version: ``compositor_fwd_plain`` with the variant.
* ``RasterizeTiled`` joins K1 and K2 (with the per-prim reduce of
  ops/gsplat.py on K3) into one differentiable function, the counterpart of
  ``rasterize_tiled_pl`` (and, with ``n_imgs > 1``, of
  ``rasterize_tiled_pl_fold``).

Each wrapper takes the kernel for a CUDA tensor and the plain version for a
CPU tensor (ops/backend.py), and adds one to ``LAUNCHES[name]`` (and to
``CARD_LAUNCHES[card][name]``) each time it launches its kernel
(``count_launch``). Nothing here builds or loads a kernel at import time.
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
# K2's pixel-to-warp maps (``k2_warp_map``): "row32", the first design's
# (one pixel a thread, a warp = 32 consecutive pixels of the tile in row
# order); "regions", the current one (4 pixels a thread, a warp = a 16x8
# region; 2 pixels and 8x8 where the tile size is not a multiple of 16)
K2_WARP_MAPS = ("row32", "regions")

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas=-v: ptxas's registers, shared memory and spills per kernel, in
# the build's log (shown only by a verbose build)
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-Xptxas=-v"]
WINDOWS = ("pallas", "xla")
PROBE_VARIANTS = ("full", "noexp", "nochain", "loadonly")  # VAR_* in the .cu
# launch counter -> kernel source (one launch name per mode of a kernel)
SOURCES = {"compositor_fwd": "compositor_fwd.cu",
           "compositor_fwd_xla": "compositor_fwd.cu",
           "compositor_fwd_fold": "compositor_fwd.cu",
           "pair_grads": "compositor_bwd.cu",
           "pair_grads_xla": "compositor_bwd.cu",
           "pair_grads_fold": "compositor_bwd.cu",
           "cumsum_cols": "cumsum.cu",
           "cumsum1d": "cumsum.cu",
           "cumsum_rows": "cumsum.cu",
           "zbuffer": "zbuffer.cu",
           "mvp_march": "mvp_march.cu",
           "mvp_march_bwd": "mvp_march_bwd.cu",
           "shadow_integral": "mvp_shadow.cu",
           **{f"probe_{v}": "compositor_fwd.cu" for v in PROBE_VARIANTS}}
# what each launch name stands for in the JAX package (file:line in its
# directory; the probe's in the repo's scripts/)
REPLACES = {
    "compositor_fwd": "ops/gsplat_pallas.py:245",
    "compositor_fwd_xla": "ops/gsplat.py:266",
    "compositor_fwd_fold": "ops/gsplat_pallas.py:845",
    "pair_grads": "ops/gsplat_pallas.py:471",
    "pair_grads_xla": "ops/gsplat.py:402",
    "pair_grads_fold": "ops/gsplat_pallas.py:863",
    "cumsum_cols": "ops/gsplat_pallas.py:169",
    "cumsum1d": "ops/gsplat_pallas.py:110",
    "cumsum_rows": "ops/gsplat_pallas.py:71",
    "zbuffer": "ops/rasterizer_pallas.py:28",
    # XLA functions of the JAX package (no pallas_call): the march's group,
    # its backward (XLA's AD of the group under jax.checkpoint) and the
    # deep-shadow integral
    "mvp_march": "ops/mvp.py:482",
    "mvp_march_bwd": "ops/mvp.py:681",
    "shadow_integral": "ops/mvp.py:814",
    **{f"probe_{v}": "scripts/probe_kernel.py:49" for v in PROBE_VARIANTS},
}

# launches of each kernel since the last reset_launch_counts(): in all, and
# by the index of the card that ran them
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
CARD_LAUNCHES: Dict[Optional[int], Dict[str, int]] = {}
_EXT = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    CARD_LAUNCHES.clear()


def count_launch(name: str, t: torch.Tensor) -> None:
    """One launch of kernel ``name`` on the card that holds ``t``."""
    LAUNCHES[name] += 1
    card = CARD_LAUNCHES.setdefault(t.device.index,
                                    {n: 0 for n in SOURCES})
    card[name] += 1


def load_kernels(verbose: bool = False):
    """Build (or reuse the build of) the kernels' extension module and
    import it. Raises with the compiler's output when the build fails.
    ``verbose`` prints the build's output, ptxas's report among it, when
    this call builds (the first of a process, with changed sources or no
    build in ``BUILD_DIR``)."""
    global _EXT
    if _EXT is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _EXT = load(name="goliath_kernels",
                    sources=[str(_CSRC / "bindings.cpp")]
                    + [str(_CSRC / src)
                       for src in sorted(set(SOURCES.values()))],
                    extra_cflags=["-O3"],
                    extra_cuda_cflags=NVCC_FLAGS,
                    build_directory=str(BUILD_DIR), verbose=verbose)
    return _EXT


# ---------------------------------------------------------------------------
# K4: inclusive int32 prefix sum
# ---------------------------------------------------------------------------


def cumsum1d_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def cumsum1d(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1-D prefix sum of an int32 vector (K4 on CUDA tensors: one
    memset and one single-pass kernel, csrc/cumsum.cu).

    The carry is integer, so unlike the TPU kernel (f32 carry, exact below
    2^24) it equals ``torch.cumsum`` bit for bit at any total, wrapping
    where it wraps."""
    if x.dim() != 1 or x.dtype != torch.int32:
        raise ValueError(f"cumsum1d takes a 1-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if target_backend(x) == "cpu":
        return cumsum1d_plain(x)
    out = load_kernels().cumsum_i32(x.contiguous())
    if x.numel():  # the binding launches nothing for an empty input
        count_launch("cumsum1d", x)
    return out


# ---------------------------------------------------------------------------
# K3: inclusive float32 prefix sums of the rows of [F, M]
# ---------------------------------------------------------------------------


def cumsum_cols_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1, dtype=torch.float32)


def cumsum_cols(x: torch.Tensor) -> torch.Tensor:
    """F independent inclusive prefix sums along dim 1 of a [F, M] float32
    tensor (K3 on CUDA tensors: one memset and one single-pass kernel,
    csrc/cumsum.cu).

    Float addition is not associative: the kernel scans each tile of 4096
    items in float32 and carries the tiles' totals in float64, in tile
    order, and ``torch.cumsum`` adds in its own order, so the two agree to
    a few ulp of each row's largest running sum, not bit for bit. The
    kernel's own bits are the same on every call."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"cumsum_cols takes a [F, M] float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if target_backend(x) == "cpu":
        return cumsum_cols_plain(x)
    out = load_kernels().cumsum_cols_f32(x.contiguous())
    if x.numel():  # the binding launches nothing for an empty input
        count_launch("cumsum_cols", x)
    return out


# ---------------------------------------------------------------------------
# K7: inclusive float32 prefix sums along axis 0 of [M, F]
# ---------------------------------------------------------------------------


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.float(), 0)


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 0 of a [M, F] float32 tensor, each of
    the F columns on its own (K7 on CUDA tensors: one memset and one
    single-pass kernel, csrc/cumsum.cu; the counterpart of
    ``cumsum_rows_pl``).

    The kernel sums each tile of whole rows in float64 and carries the
    tiles' totals in float64, in tile order, as K3 does: each output is
    rounded once to float32, it agrees with ``torch.cumsum`` to rounding,
    and its own bits are the same on every call."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"cumsum_rows takes a [M, F] float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if target_backend(x) == "cpu":
        return cumsum_rows_plain(x)
    out = load_kernels().cumsum_rows_f32(x.contiguous())
    if x.numel():  # the binding launches nothing for an empty input
        count_launch("cumsum_rows", x)
    return out


# ---------------------------------------------------------------------------
# K1: tile compositor forward (K6's with an image axis, P1's variants)
# ---------------------------------------------------------------------------


def window_blocks(max_pairs_per_tile: int, chunk: int, window: str) -> int:
    """Blocks of ``chunk`` rows in a tile's window: the Pallas kernel's
    starts at the chunk-aligned row below the tile's start and takes one
    block more than the XLA compositor's, which starts at the tile's
    start."""
    if window not in WINDOWS:
        raise ValueError(f"window must be one of {WINDOWS}, got {window!r}")
    return max_pairs_per_tile // chunk + (window == "pallas")


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
    """[B * T, C, P] -> [B, C, H, W], cropped to the image."""
    BT, C, P = tiles_cp.shape
    x = tiles_cp.reshape(-1, nty, ntx, C, ts, ts).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(-1, C, nty * ts, ntx * ts)[..., :img_h, :img_w]


def _tile_pixels(tiles, n_tiles_img, ntx, tile_size):
    """Pixel centres [n, P] (x and y) of global tiles: image-local tiles."""
    pix = torch.arange(tile_size * tile_size, device=tiles.device)
    local = tiles % n_tiles_img
    px = ((local % ntx) * tile_size).float()[:, None] \
        + ((pix % tile_size).float() + 0.5)
    py = ((local // ntx) * tile_size).float()[:, None] \
        + ((pix // tile_size).float() + 0.5)
    return px, py


def _window_start(start, chunk, window):
    """Row of block 0 of each tile's window."""
    return start if window == "xla" else (start // chunk) * chunk


def k1_pixel_map(tile_size: int) -> torch.Tensor:
    """Pixel of each (warp, lane, slot) of K1's threads in a tile, as a
    row-major index into the tile or -1 for none ([warps, 32, PPT] int64;
    csrc/compositor_fwd.cu): where the tile size is a multiple of 16, a warp
    owns a 16x8 region and lane l takes column l % 16 and rows l // 16 + 2k
    (PPT = 4); where it is a multiple of 8, an 8x8 region, rows l // 8 + 4k
    (PPT = 2); otherwise one pixel a thread in row order, the threads past
    the tile owning none (PPT = 1). For multiples of 8 the warp of each
    pixel is K2's ("regions" in ``k2_warp_map``)."""
    ts = tile_size
    P = ts * ts
    rw = 16 if ts % 16 == 0 else 8 if ts % 8 == 0 else 1
    if rw == 1:
        pix = torch.arange(-(-P // 32) * 32).reshape(-1, 32, 1)
        return torch.where(pix < P, pix, -1)
    regions_x = ts // rw
    warp = torch.arange(regions_x * (ts // 8))[:, None, None]
    lane = torch.arange(32)[None, :, None]
    x = (warp % regions_x) * rw + lane % rw
    y = (warp // regions_x) * 8 + lane // rw \
        + torch.arange(rw // 4) * (32 // rw)
    return y * ts + x


def k1_pixel_warps(tile_size: int) -> torch.Tensor:
    """Warp of each pixel of a tile in K1's map (row-major, [tile_size^2]
    int64)."""
    pixel_map = k1_pixel_map(tile_size)
    mine = pixel_map >= 0
    warp = torch.arange(pixel_map.shape[0])[:, None, None]
    owner = torch.empty(tile_size * tile_size, dtype=torch.long)
    owner[pixel_map[mine]] = warp.expand_as(pixel_map)[mine]
    return owner


def compositor_fwd_plain(rows, tile_start, tile_end, img_h: int, img_w: int,
                         tile_size: int, ntx: int, nty: int, chunk: int,
                         max_pairs_per_tile: int, n_imgs: int = 1,
                         window: str = "pallas", variant: str = "full",
                         replay_cnt: Optional[torch.Tensor] = None,
                         counts: Optional[dict] = None,
                         skip_saturated: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``_rasterize_fwd_impl``'s per-chunk cumprod
    compositing over a tile's block window. ``"pallas"``: block j covers
    rows [(start//chunk + j)*chunk, +chunk) masked to [start, end), for
    j < max_pairs_per_tile//chunk + 1, with the Pallas kernel's early-out
    (a block is skipped once the tile's max T <= 1e-4). ``"xla"``: block j
    covers [start + j*chunk, +chunk) masked by end, for j <
    max_pairs_per_tile//chunk, every block composited (the JAX XLA
    compositor). ``cnt`` is the number of blocks composited.

    ``n_imgs`` images (K6): the bounds are [n_imgs * tiles] of one binning
    over the images stacked vertically, pixel coordinates image-local.
    ``variant`` and ``replay_cnt`` are P1's (``probe_fwd``): walk the blocks
    j < replay_cnt[t] with no early-out test, with the variant's arithmetic
    (see csrc/compositor_fwd.cu).

    ``counts``, if given, receives K1's work per tile (int64 tensors
    [n_imgs * tiles] under "per_tile") and in total (ints): "evals", the
    (pair, pixel) evaluations of the rows the window reaches, every pixel
    of the tile; "warp_visits", the (row, warp) visits of K1's map
    (``k1_pixel_map``); "skipped_visits", those of the warps whose pixels
    all had T == 0 at the start of the row's block, which the kernel skips
    (none in ``"loadonly"``). T is rounded pair by pair, in the kernel's
    order, so the saturation, the early-out and cnt are read from the
    kernel's own T (the sums of colour differ in order). ``skip_saturated``
    masks those warps' pixels out of the rows they skip, as the kernel
    does: the outputs do not change (the tests hold that bit for bit).

    Tiles run in batches to bound the [tiles, chunk, pixels] temporaries to
    ``PLAIN_BATCH_ELEMS`` elements. Returns (color [n_imgs, C, H, W],
    T [n_imgs, H, W], cnt [n_imgs * tiles]), without the image axis when
    n_imgs is 1."""
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"variant must be one of {PROBE_VARIANTS}")
    C = rows.shape[1] - 8
    P = tile_size * tile_size
    n_tiles_img = ntx * nty
    n_tiles = n_imgs * n_tiles_img
    nchunks = window_blocks(max_pairs_per_tile, chunk, window)
    tile_batch = max(1, PLAIN_BATCH_ELEMS // (chunk * P))
    dev = rows.device
    lane = torch.arange(chunk, device=dev)
    last_row = rows.shape[0] - 1
    watch = (counts is not None or skip_saturated) and variant != "loadonly"
    owner = k1_pixel_warps(tile_size)
    n_warps = int(owner.max()) + 1
    owner = owner.to(dev)
    accs, Ts, cnts, works = [], [], [], []
    for t0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        start = tile_start[tiles].long()
        end = tile_end[tiles].long()
        first = _window_start(start, chunk, window)
        px, py = _tile_pixels(tiles, n_tiles_img, ntx, tile_size)
        T = torch.ones(len(tiles), P, device=dev)
        acc = torch.zeros(len(tiles), C, P, device=dev)
        cnt = torch.zeros(len(tiles), dtype=torch.int32, device=dev)
        work = torch.zeros(3, len(tiles), dtype=torch.int64, device=dev)
        for j in range(nchunks):
            base = first + j * chunk
            have = base < end
            if replay_cnt is not None:
                have = have & (j < replay_cnt[tiles])
            elif window == "pallas":
                have = have & (T.amax(dim=1) > T_EPS)
            if not bool(have.any()):
                break   # no tile of the batch takes this block or a later one
            cnt = torch.where(have, j + 1, cnt)
            idx = base[:, None] + lane                          # [n, CH]
            m = (idx >= start[:, None]) & (idx < end[:, None]) & have[:, None]
            n_rows = m.sum(dim=1)
            work[0] += n_rows * P
            work[1] += n_rows * n_warps
            if watch:   # warps whose pixels all have T == 0: [n, W]
                sat = T.new_zeros(len(tiles), n_warps).index_add_(
                    1, owner, (T != 0).float()) == 0
                work[2] += n_rows * sat.sum(dim=1)
            data = rows[idx.clamp(max=last_row)]                # [n, CH, F]
            if variant == "loadonly":
                acc = acc + torch.einsum("nk,nkc->nc", m.float(),
                                         data[..., 8:])[..., None]
                continue
            dx = data[..., 0, None] - px[:, None]               # [n, CH, P]
            dy = data[..., 1, None] - py[:, None]
            a, b, c = (data[..., k, None] for k in (2, 3, 4))
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            if variant == "noexp":
                raw = data[..., 5, None] * (1.0 - sigma).clamp(min=0.0)
            else:
                raw = data[..., 5, None] * torch.exp(-sigma.clamp(0.0, 60.0))
            alpha = raw.clamp(max=ALPHA_CLIP)
            keep = (sigma >= 0) & (alpha >= ALPHA_MIN) & m[..., None]
            if skip_saturated:
                keep = keep & ~sat[:, owner][:, None]
            alpha = torch.where(keep, alpha, 0.0)
            if variant == "nochain":
                # every pair weighted by the block's starting T; T moves
                # once, by the block's last row
                w = alpha * T[:, None]
                last = (torch.minimum(base + chunk, end) - 1 - base).clamp(
                    0, chunk - 1)
                a_last = alpha[torch.arange(len(tiles), device=dev), last]
                acc = acc + torch.einsum("nkp,nkc->ncp", w, data[..., 8:])
                T = T * (1.0 - a_last)
                continue
            # T before each row and after the block as the kernel rounds
            # it, one float32 product a row from the block's T (a cumprod
            # rounds otherwise: in float64 on the CPU), so the early-out's T
            # and cnt are K1's; rows past every tile's end keep T
            one_m = 1.0 - alpha
            k_end = int(torch.where(have, torch.minimum(base + chunk, end)
                                    - base, 0).max())
            T_rows = [T]
            for k in range(k_end):
                T_rows.append(T_rows[-1] * one_m[:, k])
            T_rows = torch.stack(T_rows + T_rows[-1:] * (chunk - k_end), 1)
            w = alpha * T_rows[:, :-1]
            acc = acc + torch.einsum("nkp,nkc->ncp", w, data[..., 8:])
            T = T_rows[:, -1]
        accs.append(acc)
        Ts.append(T)
        cnts.append(cnt)
        works.append(work)
    acc, T, cnt = torch.cat(accs), torch.cat(Ts), torch.cat(cnts)
    if counts is not None:
        work = torch.cat(works, dim=1)
        keys = ("evals", "warp_visits", "skipped_visits")
        counts["per_tile"] = dict(zip(keys, work))
        counts.update((k, int(v.sum())) for k, v in zip(keys, work))
    img = _tiles_to_image(acc, ntx, nty, tile_size, img_h, img_w)
    T_img = _tiles_to_image(T[:, None], ntx, nty, tile_size, img_h, img_w)[:, 0]
    if n_imgs == 1:
        return img[0], T_img[0], cnt
    return img, T_img, cnt


def _check_rows_and_tiles(rows, n_tiles, *tile_arrays):
    C = rows.shape[1] - 8
    if rows.dim() != 2 or rows.dtype != torch.float32 or C < 1:
        raise ValueError(f"rows must be [R, 8 + C] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    for t in tile_arrays:
        if t.shape != (n_tiles,) or t.dtype != torch.int32:
            raise ValueError(f"tile bounds and counts must be [{n_tiles}] "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    return C


def _launch_fwd(rows, tile_start, tile_end, replay_cnt, img_h, img_w,
                tile_size, ntx, chunk, nchunks, n_imgs, window, variant):
    C = rows.shape[1] - 8
    if C > MAX_CHANNELS or tile_size * tile_size > 1024:
        raise ValueError(f"K1 takes at most {MAX_CHANNELS} channels and "
                         f"32x32 tiles, got C={C}, tile {tile_size}")
    img, T, cnt = load_kernels().compositor_fwd(
        rows.contiguous(), tile_start.contiguous(), tile_end.contiguous(),
        replay_cnt.contiguous() if replay_cnt is not None
        else tile_start.new_empty(0), ntx, tile_size, img_h, img_w, chunk,
        nchunks, n_imgs, WINDOWS.index(window),
        PROBE_VARIANTS.index(variant))
    if n_imgs == 1:
        return img[0], T[0], cnt
    return img, T, cnt


def compositor_fwd(rows, tile_start, tile_end, img_h: int, img_w: int,
                   tile_size: int, ntx: int, nty: int, chunk: int,
                   max_pairs_per_tile: int, n_imgs: int = 1,
                   window: str = "pallas"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 (K6 with ``n_imgs > 1``) on CUDA tensors, ``compositor_fwd_plain``
    on CPU tensors.

    rows: [R, 8 + C] f32 from ``pack_pair_rows``; tile_start/tile_end:
    [n_imgs * ntx * nty] int32 with 0 <= start <= end <= R (bin_to_tiles
    guarantees this: both come from a searchsorted into the pair buffer).
    Returns (color [C, H, W], T [H, W], cnt [tiles] int32), with a leading
    image axis on color and T when n_imgs > 1. The batch-folded render takes
    the Pallas window only (``render`` folds only with ``use_pallas``)."""
    C = _check_rows_and_tiles(rows, n_imgs * ntx * nty, tile_start, tile_end)
    nchunks = window_blocks(max_pairs_per_tile, chunk, window)
    if n_imgs > 1 and window != "pallas":
        raise ValueError("the batch-folded compositor (K6) takes the Pallas "
                         "window only")
    if target_backend(rows) == "cpu":
        return compositor_fwd_plain(rows, tile_start, tile_end, img_h, img_w,
                                    tile_size, ntx, nty, chunk,
                                    max_pairs_per_tile, n_imgs, window)
    out = _launch_fwd(rows, tile_start, tile_end, None, img_h, img_w,
                      tile_size, ntx, chunk, nchunks, n_imgs, window, "full")
    count_launch("compositor_fwd" + ("_fold" if n_imgs > 1 else "")
                 + ("_xla" if window == "xla" else ""), rows)
    return out


def probe_fwd(rows, tile_start, tile_end, cnt, img_h: int, img_w: int,
              tile_size: int, ntx: int, nty: int, chunk: int,
              max_pairs_per_tile: int, variant: str
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P1: a variant of K1 (``PROBE_VARIANTS``, see csrc/compositor_fwd.cu)
    that walks the blocks j < cnt[t] of each tile's Pallas window, the
    blocks K1 composited when it returned ``cnt``, with no early-out test.
    ``"full"`` then equals K1 bit for bit; the others compute other things
    on purpose, over the same rows. On CPU tensors
    ``compositor_fwd_plain`` with the variant. Returns as
    ``compositor_fwd``."""
    _check_rows_and_tiles(rows, ntx * nty, tile_start, tile_end, cnt)
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"variant must be one of {PROBE_VARIANTS}")
    nchunks = window_blocks(max_pairs_per_tile, chunk, "pallas")
    if target_backend(rows) == "cpu":
        return compositor_fwd_plain(rows, tile_start, tile_end, img_h, img_w,
                                    tile_size, ntx, nty, chunk,
                                    max_pairs_per_tile, variant=variant,
                                    replay_cnt=cnt)
    out = _launch_fwd(rows, tile_start, tile_end, cnt, img_h, img_w,
                      tile_size, ntx, chunk, nchunks, 1, "pallas", variant)
    count_launch(f"probe_{variant}", rows)
    return out


# ---------------------------------------------------------------------------
# K2: tile compositor backward (per-pair gradients; K6's with an image axis)
# ---------------------------------------------------------------------------


def _image_to_tiles(img, ntx, nty, ts):
    """[B, K, H, W] -> [B * T, K, P], zero padded to whole tiles."""
    B, K, H, W = img.shape
    x = F.pad(img, (0, ntx * ts - W, 0, nty * ts - H))
    x = x.reshape(B, K, nty, ts, ntx, ts).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B * nty * ntx, K, ts * ts)


def k2_warp_map(tile_size: int, design: str) -> torch.Tensor:
    """Warp of each pixel of a tile (row-major, [tile_size^2] int64) in K2's
    design ``design`` (``K2_WARP_MAPS``; csrc/compositor_bwd.cu)."""
    pix = torch.arange(tile_size * tile_size)
    if design == "row32":
        return pix // 32
    if design != "regions":
        raise ValueError(f"design must be one of {K2_WARP_MAPS}")
    rw = 16 if tile_size % 16 == 0 else 8
    x, y = pix % tile_size, pix // tile_size
    return (y // 8) * (tile_size // rw) + x // rw


def k2_shuffles_per_visit(design: str, n_chan: int) -> int:
    """Warp shuffles K2 issues for one (pair, warp) visit in which some
    pixel keeps the pair: the first design took one 5-shuffle float32 warp
    sum per sum (6 + C); the reduce-scatter takes 8 + 4 + 2 + 1 + 1
    exchanges of a float64 (two shuffles each) for its 16 slots whatever
    C."""
    return 5 * (6 + n_chan) if design == "row32" else 32


def pair_grads_plain(rows, tile_start, tile_end, cnt, dL_dout, dL_dT,
                     T_final, tile_size: int, ntx: int, nty: int,
                     chunk: int, n_pairs: int, n_imgs: int = 1,
                     window: str = "pallas",
                     counts: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch K2: per-pair gradients [n_pairs, 16] in sorted-pair
    order (dx, dy, d conic a/b/c, d opacity, d color x C, zero pad).

    Replays ``compositor_fwd_plain`` front to back over the blocks
    ``j < cnt[t]`` of each tile's window (``window`` as for the forward)
    with the suffix-from-total identity
    ``R_i = (dT*Tf + S) - prefix_i(w q)``, ``S = sum_j w_j q_j``, and the
    same formulas as ``_compositor_bwd_kernel`` (gsplat_pallas.py:551-613).
    As in the CUDA kernel, a first pass over the blocks takes S from the
    same ``w q`` that the second subtracts, and T, q, w, S, R and dalpha's
    numerator ``q T_i (1 - alpha) - R_i`` are float64, and so are the sums
    over the tile's pixels (the alpha test, dalpha and dsigma are float32):
    for a pair deep in a pixel's list R_i is a small difference of two sums
    of S's size, dalpha one of ``q T_i`` and ``R_i / (1 - alpha)``, and the
    pixel sums cancel too (the Pallas kernel takes S as ``dout . out``,
    whose float32 rounding is as large). That kernel also
    clamps the in-block transmittance factor at 1e-20 (its log-space
    prefix's ``_LOG_CLIP``), and the JAX XLA backward divides by a reverse
    product clipped there; factors that small scale terms far below the
    float32 resolution of the sums they enter, and neither this version nor
    the CUDA kernel applies the clamp. Rows no block reaches stay zero.

    ``n_imgs`` images (K6): the image planes carry a leading image axis and
    the bounds are global, as for ``compositor_fwd_plain``.

    ``counts``, if given, receives under "kept" the number of (pair, pixel)
    evaluations inside the image that pass the alpha test (an int64 tensor):
    the only ones whose gradient terms are not zero by definition. Under
    "warp_visits" and "shuffles" it receives, per pixel-to-warp map of
    ``K2_WARP_MAPS``, the (pair, warp) visits in which at least one pixel
    keeps the pair (the pairs of the blocks j < cnt[t]) and the warp
    shuffles that design issues for them: "row32" counts a pixel outside
    the image that passes the alpha test, as that design did, "regions"
    only pixels inside it, as the current kernel does. Both count the
    second pass only."""
    C = rows.shape[1] - 8
    P = tile_size * tile_size
    n_tiles_img = ntx * nty
    n_tiles = n_imgs * n_tiles_img
    tile_batch = max(1, PLAIN_BATCH_ELEMS // (chunk * P))
    dev = rows.device
    lane = torch.arange(chunk, device=dev)
    last_row = rows.shape[0] - 1
    if n_imgs == 1:
        dL_dout, dL_dT, T_final = (x[None] for x in (dL_dout, dL_dT, T_final))
    planes = _image_to_tiles(
        torch.cat([dL_dout, dL_dT[:, None], T_final[:, None]], 1),
        ntx, nty, tile_size)                                   # [T, C+2, P]
    grads = rows.new_zeros(n_pairs, PAIR_GRAD_COLS)
    pad = rows.new_zeros(PAIR_GRAD_COLS - 6 - C)
    img_h, img_w = T_final.shape[-2:]
    if counts is not None:
        warp_maps = {d: k2_warp_map(tile_size, d).to(dev)
                     for d in K2_WARP_MAPS}
        counts.setdefault("warp_visits", {d: 0 for d in K2_WARP_MAPS})
    for t0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        start = tile_start[tiles].long()
        end = tile_end[tiles].long()
        first = _window_start(start, chunk, window)
        n_blocks = cnt[tiles]
        px, py = _tile_pixels(tiles, n_tiles_img, ntx, tile_size)
        dout = planes[tiles, :C].double()                       # [n, C, P]

        def replay():
            """The forward's blocks j < cnt, front to back: T, w and q in
            float64."""
            T = torch.ones(len(tiles), P, device=dev, dtype=torch.float64)
            for j in range(int(n_blocks.max()) if len(tiles) else 0):
                base = first + j * chunk
                have = (base < end) & (j < n_blocks)
                idx = base[:, None] + lane                      # [n, CH]
                m = (idx >= start[:, None]) & (idx < end[:, None]) \
                    & have[:, None]
                data = rows[idx.clamp(max=last_row)]            # [n, CH, F]
                dx = data[..., 0, None] - px[:, None]           # [n, CH, P]
                dy = data[..., 1, None] - py[:, None]
                a, b, c = (data[..., k] for k in (2, 3, 4))     # [n, CH]
                sigma = 0.5 * (a[..., None] * dx * dx
                               + c[..., None] * dy * dy) \
                    + b[..., None] * dx * dy
                raw = data[..., 5, None] * torch.exp(-sigma.clamp(0.0, 60.0))
                alpha = raw.clamp(max=ALPHA_CLIP)
                keep = (sigma >= 0) & (alpha >= ALPHA_MIN) & m[..., None]
                alpha = torch.where(keep, alpha, 0.0)
                cum = torch.cumprod(1.0 - alpha.double(), dim=1)
                T_i = T[:, None] * torch.cat(                   # T before i
                    [torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
                w = alpha * T_i
                q = torch.einsum("nkc,ncp->nkp", data[..., 8:].double(), dout)
                yield idx, m, data, dx, dy, raw, keep, alpha, T_i, w, q
                T = T * cum[:, -1]

        S = torch.zeros(len(tiles), P, device=dev, dtype=torch.float64)
        for *_, w, q in replay():
            S += (w * q).sum(dim=1)
        R = planes[tiles, C].double() * planes[tiles, C + 1] + S  # [n, P]
        for idx, m, data, dx, dy, raw, keep, alpha, T_i, w, q in replay():
            if counts is not None:
                inside = (px < img_w) & (py < img_h)            # [n, P]
                kept_in = keep & inside[:, None]
                counts["kept"] = counts.get("kept", 0) + kept_in.sum()
                for d, k in (("row32", keep), ("regions", kept_in)):
                    wm = warp_maps[d]
                    per_warp = k.new_zeros(k.shape[:2] + (int(wm.max()) + 1,),
                                           dtype=torch.int32)
                    per_warp.index_add_(2, wm, k.int())
                    counts["warp_visits"][d] = counts["warp_visits"][d] \
                        + (per_warp > 0).sum()
            wq = w * q
            R_i = R[:, None] - torch.cumsum(wq, dim=1)
            den = (1.0 - alpha).clamp(min=1e-3)
            dalpha = torch.where(
                keep, (q * T_i * den - R_i).float() / den, 0.0)
            draw = torch.where(raw < ALPHA_CLIP, dalpha, 0.0)
            dsigma = torch.where(keep, -raw * draw, 0.0).double()
            dx, dy = dx.double(), dy.double()                   # [n, CH, P]
            t0_ = dx * dsigma
            t1_ = dy * dsigma
            ga = 0.5 * (dx * t0_).sum(-1)
            gb = (dy * t0_).sum(-1)
            gc = 0.5 * (dy * t1_).sum(-1)
            u = t0_.sum(-1)
            v = t1_.sum(-1)
            a, b, c, op = (data[..., k].double()
                           for k in (2, 3, 4, 5))               # [n, CH]
            dop = torch.where(op > 0,
                              -dsigma.sum(-1) / op.clamp(min=1e-20), 0.0)
            dcol = torch.einsum("nkp,ncp->nkc", w, dout)        # [n, CH, C]
            block = torch.cat(
                [torch.stack([a * u + b * v, b * u + c * v, ga, gb, gc, dop],
                             dim=-1).float(), dcol.float(),
                 pad.expand(dcol.shape[:2] + pad.shape)], dim=-1)
            # every sorted pair lies in one tile's [start, end): the masked
            # rows are distinct, so this is a plain store
            grads[idx[m]] = block[m]
            R = R - wq.sum(dim=1)
    if counts is not None:
        counts["shuffles"] = {d: counts["warp_visits"][d]
                              * k2_shuffles_per_visit(d, C)
                              for d in K2_WARP_MAPS}
    return grads


def pair_grads(rows, tile_start, tile_end, cnt, dL_dout, dL_dT, T_final,
               tile_size: int, ntx: int, nty: int, chunk: int,
               n_pairs: int, n_imgs: int = 1,
               window: str = "pallas") -> torch.Tensor:
    """K2 (K6's backward with ``n_imgs > 1``) on CUDA tensors,
    ``pair_grads_plain`` on CPU tensors.

    rows/tile_start/tile_end as for ``compositor_fwd`` (tile ends within
    ``n_pairs``, the pair budget); cnt [tiles] int32 and T_final [H, W] are
    the forward's outputs; dL_dout [C, H, W] and dL_dT [H, W] the gradients
    with respect to its color and T (image planes with a leading image axis
    when n_imgs > 1). Returns [n_pairs, 16] f32 in (global) sorted-pair
    order."""
    n_tiles = n_imgs * ntx * nty
    C = _check_rows_and_tiles(rows, n_tiles, tile_start, tile_end, cnt)
    if window not in WINDOWS:
        raise ValueError(f"window must be one of {WINDOWS}, got {window!r}")
    if n_imgs > 1 and window != "pallas":
        raise ValueError("the batch-folded compositor (K6) takes the Pallas "
                         "window only")
    H, W = T_final.shape[-2:]
    lead = (n_imgs,) if n_imgs > 1 else ()
    for t, shape in ((dL_dout, lead + (C, H, W)), (dL_dT, lead + (H, W)),
                     (T_final, lead + (H, W))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"image planes must be float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if target_backend(rows) == "cpu":
        return pair_grads_plain(rows, tile_start, tile_end, cnt, dL_dout,
                                dL_dT, T_final, tile_size, ntx, nty, chunk,
                                n_pairs, n_imgs, window)
    if C > MAX_CHANNELS or tile_size % 8 or not 0 < tile_size <= 32:
        raise ValueError(f"K2 takes at most {MAX_CHANNELS} channels and "
                         f"tile sizes 8, 16, 24 or 32, got C={C}, tile "
                         f"{tile_size}")
    planes = [x.contiguous() if n_imgs > 1 else x.contiguous()[None]
              for x in (dL_dout, dL_dT, T_final)]
    grads = load_kernels().compositor_bwd(
        rows.contiguous(), tile_start.contiguous(), tile_end.contiguous(),
        cnt.contiguous(), *planes, ntx, tile_size, chunk, n_pairs,
        WINDOWS.index(window))
    count_launch("pair_grads" + ("_fold" if n_imgs > 1 else "")
                 + ("_xla" if window == "xla" else ""), rows)
    return grads


# ---------------------------------------------------------------------------
# the differentiable tile compositor
# ---------------------------------------------------------------------------


class RasterizeTiled(torch.autograd.Function):
    """Tiled compositor with its hand-written backward (counterpart of
    ``rasterize_tiled_pl``, gsplat_pallas.py:745-810, and with ``n_imgs > 1``
    of ``rasterize_tiled_pl_fold``, :828-894; with the ``"xla"`` window of
    the JAX XLA ``rasterize_tiled``, ops/gsplat.py:249-513). The forward
    packs the pair rows and runs K1 (K6); it keeps the rows, K1's final T
    and ``cnt`` (the backward replays the forward up to ``cnt``) and the
    binning's permutation and per-prim slot ranges. The backward runs K2 (K6) and reduces the per-pair
    gradients to per-prim sums with one reduce on K3
    (``ops.gsplat.reduce_sorted_pair_grads``): the binning's perm and slot
    ranges are global over the images, so one reduce serves them all."""

    @staticmethod
    def forward(ctx, xys, conics, opacities, colors, valid, sorted_prim,
                tile_start, tile_end, perm, prim_offsets, prim_ends,
                img_h, img_w, tile_size, max_pairs_per_tile, chunk, ntx, nty,
                window, n_imgs):
        nchunks = window_blocks(max_pairs_per_tile, chunk, window)
        rows = pack_pair_rows(xys, conics, opacities, colors,
                              valid.to(xys.dtype), sorted_prim,
                              nchunks * chunk)
        out, T, cnt = compositor_fwd(rows, tile_start, tile_end, img_h,
                                     img_w, tile_size, ntx, nty, chunk,
                                     max_pairs_per_tile, n_imgs, window)
        ctx.save_for_backward(rows, T, cnt, tile_start, tile_end, perm,
                              prim_offsets, prim_ends)
        ctx.dims = (tile_size, ntx, nty, chunk, sorted_prim.shape[0],
                    colors.shape[1], opacities.shape, n_imgs, window)
        return out, T

    @staticmethod
    def backward(ctx, d_out, d_T):
        from goliath_torch.ops.gsplat import reduce_sorted_pair_grads

        (rows, T, cnt, tile_start, tile_end, perm, prim_offsets,
         prim_ends) = ctx.saved_tensors
        (tile_size, ntx, nty, chunk, budget, C, op_shape, n_imgs,
         window) = ctx.dims
        sorted_g = pair_grads(rows, tile_start, tile_end, cnt, d_out, d_T, T,
                              tile_size, ntx, nty, chunk, budget, n_imgs,
                              window)
        acc = reduce_sorted_pair_grads(sorted_g[:, :6 + C], perm,
                                       prim_offsets, prim_ends)   # [F, N]
        return (acc[0:2].T, acc[2:5].T, acc[5].reshape(op_shape), acc[6:].T,
                ) + (None,) * 16


def rasterize_tiled(xys, conics, opacities, colors, valid, sorted_prim,
                    tile_start, tile_end, perm, prim_offsets, prim_ends,
                    img_h: int, img_w: int, tile_size: int,
                    max_pairs_per_tile: int, chunk: int, ntx: int, nty: int,
                    window: str = "pallas", n_imgs: int = 1):
    """Tiled splat compositing: ([C, H, W], T [H, W]), differentiable with
    respect to xys [N, 2], conics [N, 3], opacities and colors [N, C]. The
    other tensors are the binning's (``ops.binning.TileBinning``). With
    ``n_imgs > 1`` (the batch-folded render, K6) the prims and the binning
    are global over the images stacked vertically in tile space, and color
    and T gain a leading image axis."""
    return RasterizeTiled.apply(xys, conics, opacities, colors, valid,
                                sorted_prim, tile_start, tile_end, perm,
                                prim_offsets, prim_ends, img_h, img_w,
                                tile_size, max_pairs_per_tile, chunk, ntx,
                                nty, window, n_imgs)
