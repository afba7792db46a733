// K2: gaussian-splat tile compositor, backward (per-pair gradients).
//
// Replaces the JAX package's ops/gsplat_pallas.py `_compositor_bwd_kernel`
// via `pair_grads_pallas` (pallas_call at gsplat_pallas.py:726).
//
// Given the forward's pair rows, its rendered color `out`, its final
// transmittance Tf, its per-tile processed-block count `cnt`, and the
// upstream gradients dout [C, H, W] and dT [H, W], write one row of 16
// floats per sorted pair:
//   dx, dy, d(conic a, b, c), d(opacity), d(color) x C, zero pad.
// Per pixel the forward is replayed front to back with the identity
//   R_i := dT*Tf + sum_{j>i} w_j q_j = (dT*Tf + dout.out) - prefix_i(w q)
// (q_i = col_i . dout, w_i = alpha_i T_i), so no back-to-front pass is
// needed:
//   dalpha = keep ? q*T_i - R_i / max(1 - alpha, 1e-3) : 0
//   draw   = raw < 0.999 ? dalpha : 0        (the alpha clip's gradient)
//   dsigma = keep ? -raw*draw : 0
// and, summed over the tile's pixels (d0, d1 = pair center - pixel center),
//   ga = 1/2 sum d0^2 dsigma, gb = sum d0 d1 dsigma, gc = 1/2 sum d1^2 dsigma
//   u = sum d0 dsigma, v = sum d1 dsigma, gx = a u + b v, gy = b u + c v
//   dop = op > 0 ? -sum dsigma / max(op, 1e-20) : 0
//   dcol_c = sum w dout_c.
// The sums stay in this direct form: recovering the position gradients from
// moments of dsigma cancels catastrophically (gsplat_pallas.py:590-595).
//
// Design: one thread block per tile, one thread per pixel, as K1. Each
// thread keeps T, the running prefix Pq = sum w q, its dout[C] and
// R0 = dT*Tf + dout.out in registers and walks the same chunk-aligned row
// blocks as K1, for j < cnt[t] only, so the transmittance trajectory is the
// forward's (sigma, alpha and the T update are the shared code of
// splat_alpha.cuh). The TPU kernel's triangular prefix matmuls, log-space
// products and block-revisit bookkeeping have no counterpart here.
//
// The 6 + C per-pair sums over the tile's pixels are taken in three steps:
// warp shuffles, per-warp partials in shared memory for ROW_BATCH pairs at
// a time, then one thread per (pair, output column) adds the warps'
// partials and stores its float. A warp in which no pixel keeps the pair
// skips the arithmetic and writes zero partials.
//
// No atomics: a sorted pair lies in exactly one tile's [start, end), so
// each output row is stored once, by one block, into an output the caller
// zero-filled. Rows the forward never composited (behind the early-out,
// past the window of an overflowing tile, unused slots) stay zero. The
// result is deterministic.
//
// Bound: operations. Every (pair, pixel) evaluation the forward's cnt
// reaches takes the 16 of the alpha test (as K1). Only an evaluation that
// passes it (keep) needs more, its terms being zero otherwise: 2C for q, 11
// for Pq, R, dalpha, draw, dsigma and the T update, 5 + C products for the
// summands and 6 + C additions to reduce them, 22 + 4C (38 at C = 4). The
// bytes (rows read, 64 bytes written per pair, five image planes) are far
// below that at 3.35 TB/s.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates and zero-fills the output. The launcher allocates nothing,
// launches on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_alpha.cuh"

#define ROW_BATCH 16   // pairs whose per-warp partials are held at once
#define OUT_COLS 16    // floats per output row
#define N_SUMS 6       // ga, gb, gc, u, v, sum(dsigma); then C color sums
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__global__ void __launch_bounds__(1024)
compositor_bwd_kernel(const float* __restrict__ rows, int feat, int n_chan,
                      const int32_t* __restrict__ tile_start,
                      const int32_t* __restrict__ tile_end,
                      const int32_t* __restrict__ tile_cnt,
                      const float* __restrict__ dL_dout,
                      const float* __restrict__ dL_dT,
                      const float* __restrict__ T_final,
                      const float* __restrict__ out_img, int ntx,
                      int tile_size, int img_h, int img_w, int chunk,
                      float* __restrict__ pair_grads) {
  extern __shared__ float smem[];
  float* s_rows = smem;                 // [chunk, feat]
  float* s_part = smem + chunk * feat;  // [ROW_BATCH, n_warps, OUT_COLS]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = blockDim.x >> 5;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int cnt = tile_cnt[t];
  const int gx = (t % ntx) * tile_size + p % tile_size;
  const int gy = (t / ntx) * tile_size + p / tile_size;
  const float px = (float)gx + 0.5f;
  const float py = (float)gy + 0.5f;
  const int n_sums = N_SUMS + n_chan;

  // pixels outside the image take zero gradient: dout = dT = 0 gives
  // R0 = 0, q = 0 and so dsigma = 0 and w*dout = 0 for every pair
  float dout[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) dout[c] = 0.0f;
  float R0 = 0.0f;
  if (gx < img_w && gy < img_h) {
    const long long hw = (long long)img_h * img_w;
    const long long pix = (long long)gy * img_w + gx;
    R0 = dL_dT[pix] * T_final[pix];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < n_chan) {
        dout[c] = dL_dout[c * hw + pix];
        R0 += dout[c] * out_img[c * hw + pix];
      }
  }
  float T = 1.0f;
  float Pq = 0.0f;

  const int first = start / chunk;
  for (int j = 0; j < cnt; ++j) {
    const int base = (first + j) * chunk;
    if (base >= end) break;  // block-uniform
    const int lo = base > start ? base : start;
    const int hi = (base + chunk) < end ? (base + chunk) : end;
    const int n = hi - lo;
    const int nf = n * feat;
    __syncthreads();  // the previous block's reads of s_rows are over
    for (int i = p; i < nf; i += blockDim.x)
      s_rows[i] = rows[(long long)lo * feat + i];
    __syncthreads();

    for (int r0 = 0; r0 < n; r0 += ROW_BATCH) {
      const int nb = (n - r0) < ROW_BATCH ? (n - r0) : ROW_BATCH;
      for (int rb = 0; rb < nb; ++rb) {
        const float* d = s_rows + (r0 + rb) * feat;
        float* part = s_part + (rb * n_warps + warp) * OUT_COLS;
        const PairAlpha pa = pair_alpha(d, px, py);
        if (!__any_sync(FULL_MASK, pa.keep)) {  // warp-uniform
          if (lane < n_sums) part[lane] = 0.0f;
          continue;
        }
        float w = 0.0f, dsigma = 0.0f;
        if (pa.keep) {
          w = pa.alpha * T;
          float q = 0.0f;
#pragma unroll
          for (int c = 0; c < MAX_C; ++c)
            if (c < n_chan) q += d[ROW_HEAD + c] * dout[c];
          Pq += w * q;
          const float R = R0 - Pq;
          const float dalpha = q * T - R / fmaxf(1.0f - pa.alpha, 1e-3f);
          const float draw = pa.raw < ALPHA_CLIP ? dalpha : 0.0f;
          dsigma = -pa.raw * draw;
          T = transmit(T, pa.alpha);
        }
        const float t0 = pa.dx * dsigma;
        const float t1 = pa.dy * dsigma;
        float s;
        s = warp_sum(pa.dx * t0);
        if (lane == 0) part[0] = s;
        s = warp_sum(pa.dy * t0);
        if (lane == 0) part[1] = s;
        s = warp_sum(pa.dy * t1);
        if (lane == 0) part[2] = s;
        s = warp_sum(t0);
        if (lane == 0) part[3] = s;
        s = warp_sum(t1);
        if (lane == 0) part[4] = s;
        s = warp_sum(dsigma);
        if (lane == 0) part[5] = s;
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < n_chan) {
            s = warp_sum(w * dout[c]);
            if (lane == 0) part[N_SUMS + c] = s;
          }
      }
      __syncthreads();
      // one thread per (pair of the batch, output column)
      for (int i = p; i < nb * OUT_COLS; i += blockDim.x) {
        const int rb = i / OUT_COLS;
        const int col = i % OUT_COLS;
        const float* d = s_rows + (r0 + rb) * feat;
        const float* part = s_part + rb * n_warps * OUT_COLS;
        float val = 0.0f;
        if (col < 2) {  // gx = a u + b v, gy = b u + c v
          float u = 0.0f, v = 0.0f;
          for (int wi = 0; wi < n_warps; ++wi) {
            u += part[wi * OUT_COLS + 3];
            v += part[wi * OUT_COLS + 4];
          }
          val = col == 0 ? d[2] * u + d[3] * v : d[3] * u + d[4] * v;
        } else if (col < N_SUMS + n_chan) {
          // columns 2..4 read sums 0..2 (ga, gb, gc), column 5 sum 5
          // (dsigma), color columns their own sum
          const int k = col < 5 ? col - 2 : col;
          float sum = 0.0f;
          for (int wi = 0; wi < n_warps; ++wi) sum += part[wi * OUT_COLS + k];
          if (col == 2 || col == 4) {
            val = 0.5f * sum;
          } else if (col == 5) {
            const float op = d[5];
            val = op > 0.0f ? -sum / fmaxf(op, 1e-20f) : 0.0f;
          } else {
            val = sum;
          }
        }
        pair_grads[(long long)(lo + r0 + rb) * OUT_COLS + col] = val;
      }
      __syncthreads();  // s_part is reused by the next batch
    }
  }
}

// Shared memory of one block, in bytes.
static size_t bwd_smem_bytes(int chunk, int feat, int threads) {
  return ((size_t)chunk * feat + (size_t)ROW_BATCH * (threads / 32) * OUT_COLS)
         * sizeof(float);
}

// rows: [n_rows, feat] f32 (feat = 8 + n_chan); tile_start/end/cnt:
// [n_tiles] i32 with 0 <= start <= end <= n_out_rows <= n_rows;
// dL_dout/out_img: [n_chan, img_h, img_w]; dL_dT/T_final: [img_h, img_w];
// pair_grads: [n_out_rows, 16], zero-filled by the caller. tile_size^2 must
// be a multiple of 32 (whole warps). Returns the launch's CUDA error.
extern "C" int goliath_compositor_bwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, const int32_t* tile_cnt, int n_tiles,
    const float* dL_dout, const float* dL_dT, const float* T_final,
    const float* out_img, int ntx, int tile_size, int img_h, int img_w,
    int chunk, float* pair_grads, cudaStream_t stream) {
  const int threads = tile_size * tile_size;
  if (n_chan > MAX_C || N_SUMS + n_chan > OUT_COLS || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const size_t smem = bwd_smem_bytes(chunk, feat, threads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        compositor_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  compositor_bwd_kernel<<<n_tiles, threads, smem, stream>>>(
      rows, feat, n_chan, tile_start, tile_end, tile_cnt, dL_dout, dL_dT,
      T_final, out_img, ntx, tile_size, img_h, img_w, chunk, pair_grads);
  return (int)cudaGetLastError();
}
