// K1: gaussian-splat tile compositor, forward; with an image axis, K6's
// forward; in its probe variants, the ablation probe P1.
//
// Replaces the JAX package's ops/gsplat_pallas.py `_compositor_kernel` via
// `rasterize_tiled_pallas_fwd` (pallas_call at gsplat_pallas.py:428), with
// n_imgs > 1 its batch-folded use by `rasterize_tiled_pl_fold` (K6), and the
// kernel variants of scripts/probe_kernel.py `make_kernel` (P1).
//
// Per screen tile, composite the depth-sorted pair rows front to back:
//   sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy
//   alpha = min(0.999, op * exp(-clip(sigma, 0, 60)))
//   pairs with sigma < 0 or alpha < 1/255 are skipped
//   color += alpha*T*col; T *= 1 - alpha
// Outputs C-channel color [n_imgs, C, H, W], final transmittance
// T [n_imgs, H, W] (both cropped to the image) and the per-tile processed-
// block count cnt [n_imgs * tiles].
//
// Design (redesigned for the H100): one thread block per tile, PPT pixels
// a thread, with K2's map (compositor_bwd.cu). Where the tile size is a
// multiple of 16, each warp owns a 16x8 region of the tile and lane l takes
// column l % 16 and rows l / 16 + 2k, k < 4 (PPT = 4: 256 threads a 32x32
// tile, 64 a 16x16 one); where it is a multiple of 8, an 8x8 region with
// rows l / 8 + 4k, k < 2 (PPT = 2); for any other size up to 32, one pixel
// a thread in row order (PPT = 1, the thread count rounded up to whole
// warps; the threads past the tile own no pixel). A thread's pixels share
// one column, so they share dx and each staged row's head (x, y, a, b, c,
// op: two 16-byte shared-memory loads), which it reads once for all of
// them; it reads the row's C colours (16-byte loads) only when one of its
// pixels keeps the pair. T and C accumulators per pixel live in registers
// (the channel count C, 1..8, is a template parameter), and each pixel is
// composited sequentially, front to back, so the TPU's log-space
// triangular prefix matmul (gsplat_pallas.py:306-321) is not needed. Pair
// rows are staged through shared memory one block of `chunk` rows at a
// time, bounded by `end`, so the row buffer needs no padding: 16-byte
// copies where a row is a multiple of 4 floats wide (C = 4, 8), else one
// float a copy into rows padded to such a width. Blocks are small (at most
// 256 threads at tile 32, with a register cap of 4 blocks an SM up to
// C = 4), so several tiles share an SM and one tile's barriers and staging
// overlap another's row loop; a second row buffer filled by cp.async while
// the first is composited measured slower (PERF.md), so staging waits.
//
// Saturated pixels: once every pixel of a warp has T == 0.0f exactly, the
// warp skips the row loop of every later block (a warp-uniform
// __all_sync, once per block). That is exact for finite rows: such a pixel
// would add w = alpha * 0 = +0 times a colour to its sums, which leaves
// them as they are, and T * (1 - alpha) stays 0. The warp still stages
// rows, meets both barriers and votes in the early-out. Pixels outside the
// image are composited like the others: the early-out below takes their T,
// as the TPU kernel's max over the tile does, and K2 replays up to cnt.
//
// Two block windows (template XLA):
//   * the Pallas kernel's (XLA false): block j of tile t covers rows
//     [(start/chunk + j)*chunk, +chunk) clipped to [start, end), for
//     j < nchunks = max_pairs_per_tile/chunk + 1, exactly the TPU kernel's
//     BlockSpec window; with its early-out (gsplat_pallas.py:269-275):
//     before each block the block-wide max of T is tested against 1e-4
//     (__syncthreads_or(T > 1e-4) over every pixel of the tile); once it
//     fails, no later block is touched;
//   * the JAX XLA compositor's (XLA true, `_rasterize_fwd_impl`,
//     gsplat.py:266-302, what `render` runs with use_pallas false): block j
//     covers [start + j*chunk, +chunk) masked by `end`, for
//     j < nchunks = max_pairs_per_tile/chunk, with no early-out.
// cnt = 1 + the index of the last block composited, exactly as the TPU
// kernel writes it, because the backward kernel (K2) replays up to it.
//
// The image axis (K6) is blockIdx.y: tile t = image * tiles_per_img +
// blockIdx.x indexes the global tile bounds of one binning over the B
// images stacked vertically in tile space, and pixel coordinates come from
// the image-local tile blockIdx.x.
//
// P1's variants (template VARIANT; the production kernel is VAR_FULL) walk
// the blocks j < replay_cnt[t] that K1 composited, with no early-out test,
// so all read the same rows: the right traffic, wrong results on purpose.
//   VAR_FULL     the arithmetic above (with replay_cnt, equal to K1 bit for
//                bit);
//   VAR_NOEXP    op * max(1 - sigma, 0) in place of the exp;
//   VAR_NOCHAIN  no per-pair transmittance dependency: each pair is weighted
//                by the T at the start of its block, and T is updated once
//                per block, by the block's last row (the JAX `nomm`);
//   VAR_LOADONLY stage the rows and add their raw colours, no alpha math
//                (the JAX `dmaonly`): every pixel of the tile gets the same
//                sums, so a thread keeps one set for its pixels, and no
//                warp skips (the sums do not depend on T).
// The saturated-warp skip is exact in the other three as in K1.
//
// Bound: operations. Each (pair, pixel) costs one expf and ~20 FLOPs; at
// full width a frame has ~2-3M pairs x 1024 pixels ~ 2-3G evaluations.
// The rows read (48 bytes each, ~150 MB) are far below that at 3.35 TB/s.
//
// The drop tests (sigma < 0, alpha < 1/255) are discontinuous, so sigma,
// the raw alpha and the T update come from splat_alpha.cuh, which rounds
// them exactly as the plain PyTorch version does and which the backward
// kernel (K2) shares; only the compositing sums differ in order. Each
// pixel walks its rows in the same order, with the same operations, as in
// the one-pixel-a-thread design this replaces, so its T, its sums and cnt
// are that design's bit for bit.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the outputs. The launcher allocates nothing, launches on the
// given stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_alpha.cuh"

#define VAR_FULL 0
#define VAR_NOEXP 1
#define VAR_NOCHAIN 2
#define VAR_LOADONLY 3
#define REGION_H 8  // rows of a warp's region of the tile
#define FULL_MASK 0xffffffffu

// Stage rows [lo, lo + n) of FEAT floats into shared memory at a row stride
// of SF floats (FEAT rounded up to a multiple of 4), 16 bytes a copy where
// the rows are that wide and aligned (C = 4 and 8).
template <int FEAT, int SF>
__device__ __forceinline__ void stage_rows(float* s_rows,
                                           const float* __restrict__ rows,
                                           int lo, int n) {
  const float* src = rows + (long long)lo * FEAT;
  if (FEAT == SF && ((uintptr_t)src & 15) == 0) {  // block-uniform
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(s_rows);
    for (int i = threadIdx.x; i < n * (FEAT / 4); i += blockDim.x)
      dst4[i] = __ldg(src4 + i);
  } else {
    for (int i = threadIdx.x; i < n * FEAT; i += blockDim.x)
      s_rows[(i / FEAT) * SF + i % FEAT] = __ldg(src + i);
  }
}

// The NC colours of a staged row (16-byte loads; the row's stride is a
// multiple of 4 floats).
template <int NC>
__device__ __forceinline__ void row_colors(const float4* d4,
                                           float (&color)[NC]) {
#pragma unroll
  for (int i = 0; i < (NC + 3) / 4; ++i) {
    const float4 v = d4[ROW_HEAD / 4 + i];
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * i + c < NC) color[4 * i + c] = f[c];
  }
}

// RW: the width of a warp's region, 16 or 8 (PPT = RW / 4 pixels a thread),
// or 1 for one pixel a thread in row order. NC: the colour channels.
template <int VARIANT, bool XLA, int RW, int NC>
__global__ void __launch_bounds__(RW == 16 ? 256 : RW == 8 ? 288 : 1024,
                                  RW == 1 ? 1 : NC <= 4 ? 4 : 3)
compositor_fwd_kernel(const float* __restrict__ rows,
                      const int32_t* __restrict__ tile_start,
                      const int32_t* __restrict__ tile_end,
                      const int32_t* __restrict__ replay_cnt, int ntx,
                      int tiles_per_img, int tile_size, int img_h, int img_w,
                      int chunk, int nchunks, float* __restrict__ out_img,
                      float* __restrict__ out_T,
                      int32_t* __restrict__ out_cnt) {
  constexpr int PPT = RW == 1 ? 1 : RW / 4;
  constexpr int LANE_ROWS = RW == 1 ? 0 : 32 / RW;  // row step of a pixel
  constexpr int FEAT = ROW_HEAD + NC;
  constexpr int SF = (FEAT + 3) & ~3;
  extern __shared__ float4 s_rows4[];      // [chunk, SF] floats
  float* s_rows = reinterpret_cast<float*>(s_rows4);
  const int img = blockIdx.y;
  const int tl = blockIdx.x;  // image-local tile
  const int t = img * tiles_per_img + tl;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_end[t];
  int lx, ly0;
  bool owns = true;  // false for the threads past the tile (RW 1)
  if (RW == 1) {
    lx = p % tile_size;
    ly0 = p / tile_size;
    owns = p < tile_size * tile_size;
  } else {
    const int lane = p & 31;
    const int warp = p >> 5;
    const int regions_x = tile_size / RW;
    lx = (warp % regions_x) * RW + lane % RW;
    ly0 = (warp / regions_x) * REGION_H + lane / RW;
  }
  const int gx = (tl % ntx) * tile_size + lx;
  const int gy0 = (tl / ntx) * tile_size + ly0;
  const float px = (float)gx + 0.5f;

  // per pixel k (tile row ly0 + k * LANE_ROWS); a thread that owns no pixel
  // starts at T = 0: it never holds up the early-out and never keeps its
  // warp from skipping
  float py[PPT], T[PPT], acc[PPT][NC];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    py[k] = (float)(gy0 + k * LANE_ROWS) + 0.5f;
    T[k] = owns ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[k][c] = 0.0f;
  }
  int cnt = 0;

  const int first = XLA ? start : (start / chunk) * chunk;  // block 0's row
  const int n_blocks = replay_cnt != nullptr ? replay_cnt[t] : nchunks;
  for (int j = 0; j < n_blocks; ++j) {
    const int base = first + j * chunk;
    if (base >= end) break;  // block-uniform
    // the barrier also ends the previous block's reads of s_rows
    if (XLA || replay_cnt != nullptr) {
      __syncthreads();
    } else {
      bool above = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) above |= T[k] > T_EPS;
      if (!__syncthreads_or(above)) break;  // block-wide max(T) > T_EPS
    }
    cnt = j + 1;
    const int lo = base > start ? base : start;
    const int hi = (base + chunk) < end ? (base + chunk) : end;
    const int n = hi - lo;
    stage_rows<FEAT, SF>(s_rows, rows, lo, n);
    __syncthreads();

    if (VARIANT == VAR_LOADONLY) {
      for (int r = 0; r < n; ++r) {
        float color[NC];
        row_colors<NC>(s_rows4 + r * (SF / 4), color);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[0][c] += color[c];
      }
      continue;
    }
    bool saturated = true;
#pragma unroll
    for (int k = 0; k < PPT; ++k) saturated &= T[k] == 0.0f;
    if (__all_sync(FULL_MASK, saturated)) continue;  // warp-uniform

    for (int r = 0; r < n; ++r) {
      const float4* d4 = s_rows4 + r * (SF / 4);
      const float4 h0 = d4[0];
      const float4 h1 = d4[1];
      const float head[6] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y};
      PairAlpha pa[PPT];
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        pa[k] = pair_alpha<VARIANT == VAR_NOEXP>(head, px, py[k]);
        any |= pa[k].keep;
      }
      if (!any) continue;
      float color[NC];
      row_colors<NC>(d4, color);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!pa[k].keep) continue;
        // VAR_NOCHAIN: T is the block's starting T (it moves once, below)
        const float w = pa[k].alpha * T[k];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[k][c] += w * color[c];
        if (VARIANT != VAR_NOCHAIN) T[k] = transmit(T[k], pa[k].alpha);
      }
    }
    // n is 0 where the tile is empty but its aligned window's first block
    // starts below `end` (K1 counts such a block in cnt, as the TPU kernel)
    if (VARIANT == VAR_NOCHAIN && n > 0) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const PairAlpha pa = pair_alpha(s_rows + (n - 1) * SF, px, py[k]);
        if (pa.keep) T[k] = transmit(T[k], pa.alpha);
      }
    }
  }

  if (owns && gx < img_w) {
    const long long hw = (long long)img_h * img_w;
    float* o = out_img + (long long)img * NC * hw;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int gy = gy0 + k * LANE_ROWS;
      if (gy >= img_h) continue;
      const long long pix = (long long)gy * img_w + gx;
      const float* a = acc[VARIANT == VAR_LOADONLY ? 0 : k];
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c * hw + pix] = a[c];
      out_T[img * hw + pix] = T[k];
    }
  }
  if (p == 0) out_cnt[t] = cnt;
}

typedef void (*fwd_kernel_t)(const float*, const int32_t*, const int32_t*,
                             const int32_t*, int, int, int, int, int, int,
                             int, float*, float*, int32_t*);

template <int VARIANT, bool XLA, int RW>
static fwd_kernel_t fwd_kernel_nc(int n_chan) {
  switch (n_chan) {
    case 1: return compositor_fwd_kernel<VARIANT, XLA, RW, 1>;
    case 2: return compositor_fwd_kernel<VARIANT, XLA, RW, 2>;
    case 3: return compositor_fwd_kernel<VARIANT, XLA, RW, 3>;
    case 4: return compositor_fwd_kernel<VARIANT, XLA, RW, 4>;
    case 5: return compositor_fwd_kernel<VARIANT, XLA, RW, 5>;
    case 6: return compositor_fwd_kernel<VARIANT, XLA, RW, 6>;
    case 7: return compositor_fwd_kernel<VARIANT, XLA, RW, 7>;
    case 8: return compositor_fwd_kernel<VARIANT, XLA, RW, 8>;
  }
  return nullptr;
}

template <int VARIANT, bool XLA>
static fwd_kernel_t fwd_kernel_map(int rw, int n_chan) {
  switch (rw) {
    case 16: return fwd_kernel_nc<VARIANT, XLA, 16>(n_chan);
    case 8: return fwd_kernel_nc<VARIANT, XLA, 8>(n_chan);
    case 1: return fwd_kernel_nc<VARIANT, XLA, 1>(n_chan);
  }
  return nullptr;
}

static fwd_kernel_t fwd_kernel_for(int window, int variant, int rw,
                                   int n_chan) {
  if (window == 1)
    return variant == VAR_FULL ? fwd_kernel_map<VAR_FULL, true>(rw, n_chan)
                               : nullptr;
  if (window != 0) return nullptr;
  switch (variant) {
    case VAR_FULL: return fwd_kernel_map<VAR_FULL, false>(rw, n_chan);
    case VAR_NOEXP: return fwd_kernel_map<VAR_NOEXP, false>(rw, n_chan);
    case VAR_NOCHAIN: return fwd_kernel_map<VAR_NOCHAIN, false>(rw, n_chan);
    case VAR_LOADONLY:
      return fwd_kernel_map<VAR_LOADONLY, false>(rw, n_chan);
  }
  return nullptr;
}

// rows: [n_rows, feat] f32 (feat = 8 + n_chan, n_chan 1..8); tile_start/end:
// [n_imgs * tiles_per_img] i32 with 0 <= start <= end <= n_rows; replay_cnt:
// null, or [n_imgs * tiles_per_img] i32 blocks to walk with no early-out
// test (P1). tile_size: 1..32 (16x8 warp regions where it is a multiple of
// 16, 8x8 where it is one of 8, else one pixel a thread). window: 0 the
// Pallas kernel's, 1 the XLA compositor's (full variant only); variant:
// VAR_*. Returns the launch's CUDA error.
extern "C" int goliath_compositor_fwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, const int32_t* replay_cnt, int tiles_per_img,
    int n_imgs, int ntx, int tile_size, int img_h, int img_w, int chunk,
    int nchunks, int window, int variant, float* out_img, float* out_T,
    int32_t* out_cnt, cudaStream_t stream) {
  if (n_chan < 1 || n_chan > MAX_C || feat != ROW_HEAD + n_chan ||
      tile_size < 1 || tile_size > 32 || n_imgs > 65535)
    return (int)cudaErrorInvalidValue;
  const int P = tile_size * tile_size;
  const int rw = tile_size % 16 == 0 ? 16 : tile_size % 8 == 0 ? 8 : 1;
  const int threads = rw == 16 ? P / 4 : rw == 8 ? P / 2 : (P + 31) / 32 * 32;
  fwd_kernel_t kernel = fwd_kernel_for(window, variant, rw, n_chan);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (tiles_per_img == 0 || n_imgs == 0) return 0;
  const size_t smem = (size_t)chunk * ((feat + 3) & ~3) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(tiles_per_img, n_imgs), threads, smem, stream>>>(
      rows, tile_start, tile_end, replay_cnt, ntx, tiles_per_img, tile_size,
      img_h, img_w, chunk, nchunks, out_img, out_T, out_cnt);
  return (int)cudaGetLastError();
}
