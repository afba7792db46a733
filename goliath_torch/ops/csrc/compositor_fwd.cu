// K1: gaussian-splat tile compositor, forward.
//
// Replaces the JAX package's ops/gsplat_pallas.py `_compositor_kernel` via
// `rasterize_tiled_pallas_fwd` (pallas_call at gsplat_pallas.py:428).
//
// Per screen tile, composite the depth-sorted pair rows front to back:
//   sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy
//   alpha = min(0.999, op * exp(-clip(sigma, 0, 60)))
//   pairs with sigma < 0 or alpha < 1/255 are skipped
//   color += alpha*T*col; T *= 1 - alpha
// Outputs C-channel color [C, H, W], final transmittance T [H, W] (both
// cropped to the image) and the per-tile processed-block count cnt [tiles].
//
// Design: one thread block per tile, one thread per pixel (1024 threads at
// tile 32). T and the C accumulators live in registers and each thread
// composites its pixel sequentially, so the TPU's log-space triangular
// prefix matmul (gsplat_pallas.py:306-321) is not needed. Pair rows are
// staged through shared memory one chunk-aligned block at a time: block j
// of tile t covers rows [(start/chunk + j)*chunk, +chunk) clipped to
// [start, end), for j < nchunks = max_pairs_per_tile/chunk + 1, exactly the
// TPU kernel's BlockSpec window. Reads are bounded by `end`, so the row
// buffer needs no padding.
//
// Early-out at the TPU kernel's granularity (gsplat_pallas.py:269-275):
// before each block the block-wide max of T is tested against 1e-4
// (__syncthreads_or(T > 1e-4)); once it fails, no later block is touched.
// cnt = 1 + the index of the last block composited, exactly as the TPU
// kernel writes it, because the backward kernel (K2) replays up to it.
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
// allocates the outputs. The launcher allocates nothing, launches on the given stream and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_alpha.cuh"

__global__ void __launch_bounds__(1024)
compositor_fwd_kernel(const float* __restrict__ rows, int feat, int n_chan,
                      const int32_t* __restrict__ tile_start,
                      const int32_t* __restrict__ tile_end, int ntx,
                      int tile_size, int img_h, int img_w, int chunk,
                      int nchunks, float* __restrict__ out_img,
                      float* __restrict__ out_T, int32_t* __restrict__ out_cnt) {
  extern __shared__ float s_rows[];  // [chunk, feat]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int gx = (t % ntx) * tile_size + p % tile_size;
  const int gy = (t / ntx) * tile_size + p / tile_size;
  const float px = (float)gx + 0.5f;
  const float py = (float)gy + 0.5f;

  float T = 1.0f;
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  int cnt = 0;

  const int first = start / chunk;
  for (int j = 0; j < nchunks; ++j) {
    const int base = (first + j) * chunk;
    if (base >= end) break;  // block-uniform
    // block-wide max(T) > T_EPS; also the barrier that ends the previous
    // block's reads of s_rows
    if (!__syncthreads_or(T > T_EPS)) break;
    cnt = j + 1;
    const int lo = base > start ? base : start;
    const int hi = (base + chunk) < end ? (base + chunk) : end;
    const int n = hi - lo;
    const int nf = n * feat;
    for (int i = p; i < nf; i += blockDim.x)
      s_rows[i] = rows[(long long)lo * feat + i];
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float* d = s_rows + r * feat;
      const PairAlpha pa = pair_alpha(d, px, py);
      if (!pa.keep) continue;
      const float w = pa.alpha * T;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < n_chan) acc[c] += w * d[ROW_HEAD + c];
      T = transmit(T, pa.alpha);
    }
  }

  if (gx < img_w && gy < img_h) {
    const long long hw = (long long)img_h * img_w;
    const long long pix = (long long)gy * img_w + gx;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < n_chan) out_img[c * hw + pix] = acc[c];
    out_T[pix] = T;
  }
  if (p == 0) out_cnt[t] = cnt;
}

// rows: [n_rows, feat] f32 (feat = 8 + n_chan); tile_start/end: [n_tiles]
// i32 with 0 <= start <= end <= n_rows. Returns the launch's CUDA error.
extern "C" int goliath_compositor_fwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, int n_tiles, int ntx, int tile_size, int img_h,
    int img_w, int chunk, int nchunks, float* out_img, float* out_T,
    int32_t* out_cnt, cudaStream_t stream) {
  if (n_chan > MAX_C || tile_size * tile_size > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)chunk * feat * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        compositor_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  compositor_fwd_kernel<<<n_tiles, tile_size * tile_size, smem, stream>>>(
      rows, feat, n_chan, tile_start, tile_end, ntx, tile_size, img_h, img_w,
      chunk, nchunks, out_img, out_T, out_cnt);
  return (int)cudaGetLastError();
}
