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
// Design: one thread block per tile, one thread per pixel (1024 threads at
// tile 32). T and the C accumulators live in registers and each thread
// composites its pixel sequentially, so the TPU's log-space triangular
// prefix matmul (gsplat_pallas.py:306-321) is not needed. Pair rows are
// staged through shared memory one block of `chunk` rows at a time. Reads
// are bounded by `end`, so the row buffer needs no padding.
//
// Two block windows (template XLA):
//   * the Pallas kernel's (XLA false): block j of tile t covers rows
//     [(start/chunk + j)*chunk, +chunk) clipped to [start, end), for
//     j < nchunks = max_pairs_per_tile/chunk + 1, exactly the TPU kernel's
//     BlockSpec window; with its early-out (gsplat_pallas.py:269-275):
//     before each block the block-wide max of T is tested against 1e-4
//     (__syncthreads_or(T > 1e-4)); once it fails, no later block is
//     touched;
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
//                (the JAX `dmaonly`).
//
// Bound: operations. Each (pair, pixel) costs one expf and ~20 FLOPs; at
// full width a frame has ~2-3M pairs x 1024 pixels ~ 2-3G evaluations.
// The rows read (48 bytes each, ~150 MB) are far below that at 3.35 TB/s.
// Pixels of a tile whose pairs ended early idle in the block; a later
// change can split long tiles or skip masked pixels per warp.
//
// The drop tests (sigma < 0, alpha < 1/255) are discontinuous, so sigma,
// the raw alpha and the T update come from splat_alpha.cuh, which rounds
// them exactly as the plain PyTorch version does and which the backward
// kernel (K2) shares; only the compositing sums differ in order.
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

template <int VARIANT, bool XLA>
__global__ void __launch_bounds__(1024)
compositor_fwd_kernel(const float* __restrict__ rows, int feat, int n_chan,
                      const int32_t* __restrict__ tile_start,
                      const int32_t* __restrict__ tile_end,
                      const int32_t* __restrict__ replay_cnt, int ntx,
                      int tiles_per_img, int tile_size, int img_h, int img_w,
                      int chunk, int nchunks, float* __restrict__ out_img,
                      float* __restrict__ out_T,
                      int32_t* __restrict__ out_cnt) {
  extern __shared__ float s_rows[];  // [chunk, feat]
  const int img = blockIdx.y;
  const int tl = blockIdx.x;  // image-local tile
  const int t = img * tiles_per_img + tl;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int gx = (tl % ntx) * tile_size + p % tile_size;
  const int gy = (tl / ntx) * tile_size + p / tile_size;
  const float px = (float)gx + 0.5f;
  const float py = (float)gy + 0.5f;

  float T = 1.0f;
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  int cnt = 0;

  const int first = XLA ? start : (start / chunk) * chunk;  // block 0's row
  const int n_blocks = replay_cnt != nullptr ? replay_cnt[t] : nchunks;
  for (int j = 0; j < n_blocks; ++j) {
    const int base = first + j * chunk;
    if (base >= end) break;  // block-uniform
    // the barrier also ends the previous block's reads of s_rows
    if (XLA || replay_cnt != nullptr) {
      __syncthreads();
    } else if (!__syncthreads_or(T > T_EPS)) {  // block-wide max(T) > T_EPS
      break;
    }
    cnt = j + 1;
    const int lo = base > start ? base : start;
    const int hi = (base + chunk) < end ? (base + chunk) : end;
    const int n = hi - lo;
    const int nf = n * feat;
    for (int i = p; i < nf; i += blockDim.x)
      s_rows[i] = rows[(long long)lo * feat + i];
    __syncthreads();
    const float T_block = T;
    for (int r = 0; r < n; ++r) {
      const float* d = s_rows + r * feat;
      if (VARIANT == VAR_LOADONLY) {
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < n_chan) acc[c] += d[ROW_HEAD + c];
        continue;
      }
      const PairAlpha pa = pair_alpha<VARIANT == VAR_NOEXP>(d, px, py);
      if (!pa.keep) continue;
      const float w = pa.alpha * (VARIANT == VAR_NOCHAIN ? T_block : T);
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < n_chan) acc[c] += w * d[ROW_HEAD + c];
      if (VARIANT != VAR_NOCHAIN) T = transmit(T, pa.alpha);
    }
    // n is 0 where the tile is empty but its aligned window's first block
    // starts below `end` (K1 counts such a block in cnt, as the TPU kernel)
    if (VARIANT == VAR_NOCHAIN && n > 0) {
      const PairAlpha pa = pair_alpha(s_rows + (n - 1) * feat, px, py);
      if (pa.keep) T = transmit(T, pa.alpha);
    }
  }

  if (gx < img_w && gy < img_h) {
    const long long hw = (long long)img_h * img_w;
    const long long pix = (long long)gy * img_w + gx;
    float* o = out_img + (long long)img * n_chan * hw;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < n_chan) o[c * hw + pix] = acc[c];
    out_T[img * hw + pix] = T;
  }
  if (p == 0) out_cnt[t] = cnt;
}

typedef void (*fwd_kernel_t)(const float*, int, int, const int32_t*,
                             const int32_t*, const int32_t*, int, int, int,
                             int, int, int, int, float*, float*, int32_t*);

// rows: [n_rows, feat] f32 (feat = 8 + n_chan); tile_start/end:
// [n_imgs * tiles_per_img] i32 with 0 <= start <= end <= n_rows; replay_cnt:
// null, or [n_imgs * tiles_per_img] i32 blocks to walk with no early-out
// test (P1). window: 0 the Pallas kernel's, 1 the XLA compositor's (full
// variant only); variant: VAR_*. Returns the launch's CUDA error.
extern "C" int goliath_compositor_fwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, const int32_t* replay_cnt, int tiles_per_img,
    int n_imgs, int ntx, int tile_size, int img_h, int img_w, int chunk,
    int nchunks, int window, int variant, float* out_img, float* out_T,
    int32_t* out_cnt, cudaStream_t stream) {
  if (n_chan > MAX_C || tile_size * tile_size > 1024 || n_imgs > 65535)
    return (int)cudaErrorInvalidValue;
  fwd_kernel_t kernel = nullptr;
  if (window == 1) {
    if (variant == VAR_FULL) kernel = compositor_fwd_kernel<VAR_FULL, true>;
  } else if (window == 0) {
    switch (variant) {
      case VAR_FULL: kernel = compositor_fwd_kernel<VAR_FULL, false>; break;
      case VAR_NOEXP: kernel = compositor_fwd_kernel<VAR_NOEXP, false>; break;
      case VAR_NOCHAIN:
        kernel = compositor_fwd_kernel<VAR_NOCHAIN, false>;
        break;
      case VAR_LOADONLY:
        kernel = compositor_fwd_kernel<VAR_LOADONLY, false>;
        break;
    }
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (tiles_per_img == 0 || n_imgs == 0) return 0;
  const size_t smem = (size_t)chunk * feat * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(tiles_per_img, n_imgs), tile_size * tile_size, smem,
           stream>>>(rows, feat, n_chan, tile_start, tile_end, replay_cnt,
                     ntx, tiles_per_img, tile_size, img_h, img_w, chunk,
                     nchunks, out_img, out_T, out_cnt);
  return (int)cudaGetLastError();
}
