// K2: gaussian-splat tile compositor, backward (per-pair gradients); with
// an image axis, K6's backward.
//
// Replaces the JAX package's ops/gsplat_pallas.py `_compositor_bwd_kernel`
// via `pair_grads_pallas` (pallas_call at gsplat_pallas.py:726), and with
// n_imgs > 1 its batch-folded use by `rasterize_tiled_pl_fold` (K6).
//
// Given the forward's pair rows, its final transmittance Tf, its per-tile
// processed-block count `cnt`, and the upstream gradients dout [C, H, W]
// and dT [H, W], write one row of 16 floats per sorted pair:
//   dx, dy, d(conic a, b, c), d(opacity), d(color) x C, zero pad.
// Per pixel the forward is replayed front to back with the identity
//   R_i := dT*Tf + sum_{j>i} w_j q_j = (dT*Tf + S) - prefix_i(w q)
// (q_i = col_i . dout, w_i = alpha_i T_i, S = sum_j w_j q_j over every pair
// the forward composited), so no back-to-front pass is needed:
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
// The replay is conditioned badly: for a pair deep in a pixel's list (T_i
// << 1), R_i is a small difference of two sums of the size of S, and where
// the pairs behind it have its color, dalpha is a small difference of q T_i
// and R_i / (1 - alpha). So the kernel walks the tile's blocks twice, the
// first pass taking S from the same w_j q_j that the second subtracts, and
// replays T, q, w, S, R and dalpha's numerator q T_i (1 - alpha) - R_i in
// float64; the sums over the tile's pixels, whose terms cancel too, are
// float64 as well. Only the alpha test (K1's, bit for bit), dalpha and
// dsigma are float32. Taking S as dout . out, from the forward's float32
// color, or replaying or summing in float32, put this kernel and its plain
// version further apart than the tolerance of their check on some steps of
// a full-width batch-folded training run.
//
// Design (redesigned for the H100): one thread block per tile, PPT pixels
// per thread (4 for tile sizes that are multiples of 16, so a 32x32 tile
// takes 256 threads and a 16x16 one 64; 2 otherwise, so an 8x8 tile takes
// one warp). Each warp owns a region of RW x 8 pixels of the tile (RW = 4 *
// PPT: 16x8 or 8x8): lane l takes column l % RW and rows l / RW + k * (32 /
// RW) for k < PPT. Each thread keeps, per pixel, T and the running R
// (float64) and its dout[C] in registers and walks the same row blocks as
// K1 (its Pallas or XLA window, template XLA), for j < cnt[t] only, with
// K1's keep/drop decisions (sigma and alpha are the shared code of
// splat_alpha.cuh), so the transmittance trajectory is the forward's up to
// K1's float32 rounding. The TPU kernel's triangular prefix matmuls,
// log-space products and block-revisit bookkeeping have no counterpart
// here. With the XLA window this replaces the JAX XLA compositor's
// back-to-front `_rasterize_bwd` (gsplat.py:402-512), which recovers T_i by
// dividing the final T by a reverse cumulative product clipped at 1e-20:
// the two agree wherever that product stays above the clip (the replay
// needs no division).
//
// The image axis (K6) is blockIdx.y, as in K1: t = image * tiles_per_img +
// blockIdx.x indexes the global tile bounds, pixel coordinates come from the
// image-local tile, and the image planes are [n_imgs, ...].
//
// In the second pass the 6 + C per-pair sums over the tile's pixels are
// taken in three steps, in float64:
//   1. each thread reads the staged row once for all its pixels and adds
//      its kept pixels' terms in registers (N_VALS = 16 slots, zero past
//      6 + C);
//   2. a warp in which some pixel inside the image keeps the pair reduces
//      the 16 slots with a transposed (reduce-scatter) butterfly: at the
//      stage of lane offset 16, 8, 4, 2 a lane sends half of its slots to
//      its partner and keeps the other half, adding the partner's; a last
//      xor of 1 completes the sums, and lanes 2k and 2k + 1 hold slot k.
//      That is 8 + 4 + 2 + 1 + 1 = 16 exchanges of a float64, 32 shuffles,
//      a (pair, warp) where the first design's ten 5-shuffle float32 warp
//      sums took 50 (k2_shuffles_per_visit in
//      goliath_torch/ops/gsplat_cuda.py counts both). A warp in which no
//      pixel keeps the pair writes zero partials and shuffles nothing;
//   3. per-warp partials in shared memory for ROW_BATCH pairs at a time,
//      then one thread per (pair, output column) adds the warps' partials
//      in warp order and stores its float.
// Pixels outside the image (the partial tiles at the right and bottom
// edges) take dout = dT = 0 and are never counted as keeping a pair: their
// terms are zero by construction. The channel count C (1..8) is a template
// parameter: the per-pixel state then takes 4 + C registers.
//
// No atomics: a sorted pair lies in exactly one tile's [start, end), so
// each output row is stored once, by one block, into an output the caller
// zero-filled. Rows the forward never composited (behind the early-out,
// past the window of an overflowing tile, unused slots) stay zero. The
// result is deterministic.
//
// Bound: operations. Every (pair, pixel) evaluation the forward's cnt
// reaches takes the 16 of the alpha test (as K1) in each pass. Only an
// evaluation that passes it (keep) needs more, its terms being zero
// otherwise: in the first pass 2C for q and 5 for w, w q, S and the T
// update; in the second 2C for q, 11 for w q, R, dalpha, draw, dsigma and
// the T update, 5 + C products for the summands and 6 + C additions to
// reduce them. That is 32 an evaluation and 27 + 6C (51 at C = 4) a kept
// one, most of them float64, all counted at the float32 rate. The bytes
// (rows read, 64 bytes written per pair, four image planes) are far below
// that at 3.35 TB/s.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates and zero-fills the output. The launcher allocates nothing,
// launches on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_alpha.cuh"

#define ROW_BATCH 32   // pairs whose per-warp partials are held at once
#define OUT_COLS 16    // floats per output row
#define N_SUMS 6       // ga, gb, gc, u, v, sum(dsigma); then C color sums
#define N_VALS 16      // register slots of the sums (N_SUMS + MAX_C <= 16)
#define REGION_H 8     // rows of a warp's region of the tile
#define FULL_MASK 0xffffffffu

// One stage of the reduce-scatter: lanes whose bit (2 * HALF) is set keep
// the upper HALF of v[0..2 * HALF) and send the lower, the others the
// reverse; each adds what its partner sent to what it keeps, into
// v[0..HALF).
template <int HALF>
__device__ __forceinline__ void reduce_scatter_stage(double (&v)[N_VALS],
                                                     int lane) {
  const bool upper = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const double send = upper ? v[i] : v[HALF + i];
    const double keep = upper ? v[HALF + i] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL_MASK, send, 2 * HALF);
  }
}

// Reduce-scatter of v[0..16) over the warp in 16 float64 exchanges: on
// return v[0] of lane l holds the warp's sum of slot l >> 1.
__device__ __forceinline__ void warp_reduce_scatter(double (&v)[N_VALS],
                                                    int lane) {
  static_assert(N_VALS == 16, "the stages below halve 16 slots to 1");
  reduce_scatter_stage<8>(v, lane);
  reduce_scatter_stage<4>(v, lane);
  reduce_scatter_stage<2>(v, lane);
  reduce_scatter_stage<1>(v, lane);
  v[0] += __shfl_xor_sync(FULL_MASK, v[0], 1);
}

// Block j of a tile's window (block 0 at row `first`): its rows [lo, lo +
// n) clipped to [start, end). False once the block starts past the tile's
// end (block-uniform).
__device__ __forceinline__ bool block_rows(int j, int first, int chunk,
                                           int start, int end, int& lo,
                                           int& n) {
  const int base = first + j * chunk;
  if (base >= end) return false;
  lo = base > start ? base : start;
  n = ((base + chunk) < end ? (base + chunk) : end) - lo;
  return true;
}

// Stage n rows of `feat` floats from row lo into shared memory, after the
// block's reads of the previous ones.
__device__ __forceinline__ void stage_rows(float* s_rows, const float* rows,
                                           int lo, int n, int feat) {
  __syncthreads();
  for (int i = threadIdx.x; i < n * feat; i += blockDim.x)
    s_rows[i] = rows[(long long)lo * feat + i];
  __syncthreads();
}

// q = col . dout of a (pair, pixel) in float64, alike in both passes.
template <int NC>
__device__ __forceinline__ double pixel_q(const float (&color)[NC],
                                          const float (&dout)[NC]) {
  double q = 0.0;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    q = __fma_rn((double)color[c], (double)dout[c], q);
  return q;
}

// RW: the width of a warp's region, 16 or 8 (PPT = RW / 4 pixels a
// thread); NC: the color channels, a compile-time count so that the
// per-pixel dout[NC] and the row's colors take NC registers, not MAX_C.
// Up to C = 4 the registers are held to 128 a thread, so that a 32x32
// tile's 256 threads fit 2 blocks to an SM.
template <bool XLA, int RW, int NC>
__global__ void __launch_bounds__(RW == 16 ? 256 : 288,
                                  RW == 16 && NC <= 4 ? 2 : 1)
compositor_bwd_kernel(const float* __restrict__ rows,
                      const int32_t* __restrict__ tile_start,
                      const int32_t* __restrict__ tile_end,
                      const int32_t* __restrict__ tile_cnt,
                      const float* __restrict__ dL_dout,
                      const float* __restrict__ dL_dT,
                      const float* __restrict__ T_final, int ntx,
                      int tiles_per_img, int tile_size, int img_h, int img_w,
                      int chunk, float* __restrict__ pair_grads) {
  constexpr int PPT = RW / 4;
  constexpr int LANE_ROWS = 32 / RW;  // row step between a thread's pixels
  constexpr int feat = ROW_HEAD + NC;
  extern __shared__ double smem[];
  double* s_part = smem;  // [ROW_BATCH, n_warps, OUT_COLS]
  float* s_rows = (float*)(smem + ROW_BATCH * (blockDim.x >> 5) *
                           OUT_COLS);  // [chunk, feat]
  const int img = blockIdx.y;
  const int tl = blockIdx.x;  // image-local tile
  const int t = img * tiles_per_img + tl;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = blockDim.x >> 5;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int cnt = tile_cnt[t];
  const int regions_x = tile_size / RW;
  const int gx = (tl % ntx) * tile_size + (warp % regions_x) * RW + lane % RW;
  const int gy0 = (tl / ntx) * tile_size + (warp / regions_x) * REGION_H +
                  lane / RW;
  const float px = (float)gx + 0.5f;
  const long long hw = (long long)img_h * img_w;
  const int first = XLA ? start : (start / chunk) * chunk;  // block 0's row

  // per pixel k (row gy0 + k * LANE_ROWS): pixels outside the image take
  // zero gradient (dout = dT = 0) and never count as keeping a pair
  float dout[PPT][NC];
  double T[PPT], R[PPT];
  bool inside[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int gy = gy0 + k * LANE_ROWS;
    inside[k] = gx < img_w && gy < img_h;
    T[k] = 1.0;
    R[k] = 0.0;
#pragma unroll
    for (int c = 0; c < NC; ++c) dout[k][c] = 0.0f;
    if (inside[k]) {
      const long long chans = img * NC * hw + (long long)gy * img_w + gx;
#pragma unroll
      for (int c = 0; c < NC; ++c) dout[k][c] = dL_dout[chans + c * hw];
    }
  }

  // first pass: R = S = sum of w q over the blocks j < cnt
  int lo, n;
  for (int j = 0; j < cnt && block_rows(j, first, chunk, start, end, lo, n);
       ++j) {
    stage_rows(s_rows, rows, lo, n, feat);
    for (int r = 0; r < n; ++r) {
      const float* d = s_rows + r * feat;
      float head[6], color[NC];
#pragma unroll
      for (int i = 0; i < 6; ++i) head[i] = d[i];
#pragma unroll
      for (int c = 0; c < NC; ++c) color[c] = d[ROW_HEAD + c];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float py = (float)(gy0 + k * LANE_ROWS) + 0.5f;
        const PairAlpha pa = pair_alpha(head, px, py);
        if (!(pa.keep && inside[k])) continue;
        R[k] += (double)pa.alpha * T[k] * pixel_q<NC>(color, dout[k]);
        T[k] *= 1.0 - (double)pa.alpha;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (inside[k]) {
      const long long plane =
          img * hw + (long long)(gy0 + k * LANE_ROWS) * img_w + gx;
      R[k] += (double)dL_dT[plane] * (double)T_final[plane];
    }
    T[k] = 1.0;
  }

  // second pass: R_i = R - prefix_i(w q), and the gradients
  for (int j = 0; j < cnt && block_rows(j, first, chunk, start, end, lo, n);
       ++j) {
    stage_rows(s_rows, rows, lo, n, feat);
    for (int r0 = 0; r0 < n; r0 += ROW_BATCH) {
      const int nb = (n - r0) < ROW_BATCH ? (n - r0) : ROW_BATCH;
      for (int rb = 0; rb < nb; ++rb) {
        // the row, read once for all of this thread's pixels
        const float* d = s_rows + (r0 + rb) * feat;
        float head[6], color[NC];
#pragma unroll
        for (int i = 0; i < 6; ++i) head[i] = d[i];
#pragma unroll
        for (int c = 0; c < NC; ++c) color[c] = d[ROW_HEAD + c];
        double v[N_VALS];
#pragma unroll
        for (int i = 0; i < N_VALS; ++i) v[i] = 0.0;
        bool any = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float py = (float)(gy0 + k * LANE_ROWS) + 0.5f;
          const PairAlpha pa = pair_alpha(head, px, py);
          if (!(pa.keep && inside[k])) continue;
          any = true;
          const double w64 = (double)pa.alpha * T[k];
          const double q = pixel_q<NC>(color, dout[k]);
          R[k] -= w64 * q;
          // dalpha = q T_i - R_i / den, its cancellation taken in float64
          const float den = fmaxf(1.0f - pa.alpha, 1e-3f);
          const float dalpha = (float)(q * T[k] * (double)den - R[k]) / den;
          const float draw = pa.raw < ALPHA_CLIP ? dalpha : 0.0f;
          const double dsigma = (double)(-pa.raw * draw);
          T[k] *= 1.0 - (double)pa.alpha;
          const double dx = pa.dx, dy = pa.dy;
          const double t0 = dx * dsigma;
          const double t1 = dy * dsigma;
          v[0] += dx * t0;
          v[1] += dy * t0;
          v[2] += dy * t1;
          v[3] += t0;
          v[4] += t1;
          v[5] += dsigma;
#pragma unroll
          for (int c = 0; c < NC; ++c) v[N_SUMS + c] += w64 * dout[k][c];
        }
        double* part = s_part + (rb * n_warps + warp) * OUT_COLS;
        if (__any_sync(FULL_MASK, any)) {  // warp-uniform
          warp_reduce_scatter(v, lane);
        } else {
          v[0] = 0.0;
        }
        if ((lane & 1) == 0) part[lane >> 1] = v[0];
      }
      __syncthreads();
      // one thread per (pair of the batch, output column)
      for (int i = p; i < nb * OUT_COLS; i += blockDim.x) {
        const int rb = i / OUT_COLS;
        const int col = i % OUT_COLS;
        const float* d = s_rows + (r0 + rb) * feat;
        const double* part = s_part + rb * n_warps * OUT_COLS;
        double val = 0.0;
        if (col < 2) {  // gx = a u + b v, gy = b u + c v
          double u = 0.0, v = 0.0;
          for (int wi = 0; wi < n_warps; ++wi) {
            u += part[wi * OUT_COLS + 3];
            v += part[wi * OUT_COLS + 4];
          }
          val = col == 0 ? d[2] * u + d[3] * v : d[3] * u + d[4] * v;
        } else if (col < N_SUMS + NC) {
          // columns 2..4 read sums 0..2 (ga, gb, gc), column 5 sum 5
          // (dsigma), color columns their own sum
          const int k = col < 5 ? col - 2 : col;
          double sum = 0.0;
          for (int wi = 0; wi < n_warps; ++wi) sum += part[wi * OUT_COLS + k];
          if (col == 2 || col == 4) {
            val = 0.5 * sum;
          } else if (col == 5) {
            const float op = d[5];
            val = op > 0.0f ? -sum / fmax((double)op, 1e-20) : 0.0;
          } else {
            val = sum;
          }
        }
        pair_grads[(long long)(lo + r0 + rb) * OUT_COLS + col] = (float)val;
      }
      __syncthreads();  // s_part is reused by the next batch
    }
  }
}

// Shared memory of one block, in bytes.
static size_t bwd_smem_bytes(int chunk, int feat, int threads) {
  return (size_t)ROW_BATCH * (threads / 32) * OUT_COLS * sizeof(double) +
         (size_t)chunk * feat * sizeof(float);
}

typedef void (*bwd_kernel_t)(const float*, const int32_t*, const int32_t*,
                             const int32_t*, const float*, const float*,
                             const float*, int, int, int, int, int, int,
                             float*);

template <bool XLA, int RW>
static bwd_kernel_t bwd_kernel_for(int n_chan) {
  switch (n_chan) {
    case 1: return compositor_bwd_kernel<XLA, RW, 1>;
    case 2: return compositor_bwd_kernel<XLA, RW, 2>;
    case 3: return compositor_bwd_kernel<XLA, RW, 3>;
    case 4: return compositor_bwd_kernel<XLA, RW, 4>;
    case 5: return compositor_bwd_kernel<XLA, RW, 5>;
    case 6: return compositor_bwd_kernel<XLA, RW, 6>;
    case 7: return compositor_bwd_kernel<XLA, RW, 7>;
    case 8: return compositor_bwd_kernel<XLA, RW, 8>;
  }
  return nullptr;
}

// rows: [n_rows, feat] f32 (feat = 8 + n_chan); tile_start/end/cnt:
// [n_imgs * tiles_per_img] i32 with 0 <= start <= end <= n_out_rows <=
// n_rows; dL_dout: [n_imgs, n_chan, img_h, img_w]; dL_dT/T_final:
// [n_imgs, img_h, img_w]; pair_grads: [n_out_rows, 16], zero-filled by the
// caller. tile_size: a multiple of 8 up to 32 (warp regions of 16x8 pixels
// where it is a multiple of 16, else 8x8). window: 0 the Pallas kernel's
// block window, 1 the XLA compositor's (as K1). Returns the launch's CUDA
// error.
extern "C" int goliath_compositor_bwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, const int32_t* tile_cnt, int tiles_per_img,
    int n_imgs, const float* dL_dout, const float* dL_dT,
    const float* T_final, int ntx, int tile_size, int img_h, int img_w,
    int chunk, int window, float* pair_grads, cudaStream_t stream) {
  if (n_chan < 1 || n_chan > MAX_C || feat != ROW_HEAD + n_chan ||
      N_SUMS + n_chan > OUT_COLS || tile_size <= 0 ||
      tile_size > 32 || tile_size % 8 != 0 || (window != 0 && window != 1) ||
      n_imgs > 65535)
    return (int)cudaErrorInvalidValue;
  if (tiles_per_img == 0 || n_imgs == 0) return 0;
  const bool wide = tile_size % 16 == 0;
  const int threads = tile_size * tile_size / (wide ? 4 : 2);
  const bwd_kernel_t kernel =
      window == 1 ? (wide ? bwd_kernel_for<true, 16>(n_chan)
                          : bwd_kernel_for<true, 8>(n_chan))
                  : (wide ? bwd_kernel_for<false, 16>(n_chan)
                          : bwd_kernel_for<false, 8>(n_chan));
  const size_t smem = bwd_smem_bytes(chunk, feat, threads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(tiles_per_img, n_imgs), threads, smem, stream>>>(
      rows, tile_start, tile_end, tile_cnt, dL_dout, dL_dT, T_final, ntx,
      tiles_per_img, tile_size, img_h, img_w, chunk, pair_grads);
  return (int)cudaGetLastError();
}
