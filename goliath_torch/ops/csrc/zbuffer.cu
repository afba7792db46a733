// K5: mesh z-buffer, the per-pixel nearest face of the tile-binned faces.
//
// Replaces the JAX package's ops/rasterizer_pallas.py `_zbuffer_kernel` via
// `rasterize_zbuffer_pallas` (pallas_call at rasterizer_pallas.py:150).
//
// Face rows [R, 16] f32 in sorted-pair order (ops/rasterizer_cuda.py
// pack_face_rows): a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | |inv_area|*valid |
// iz0 iz1 iz2 | 3 pad. For pixel centre (px, py) and row s of tile t:
//   E_k = a_k*px + b_k*py + c_k           (edge functions, positive inside)
//   izp = (E0*iz0 + E1*iz1 + E2*iz2) * |inv_area|   (perspective 1/z)
//   zp  = 1 / max(izp, 1e-12), or BIG unless E0,E1,E2 >= 0 and izp > 0
// and the pixel keeps the smallest zp, ties going to the lowest row s. The
// output is the face id sorted_prim[s] (-1 where nothing was hit) and zp
// (BIG there), written straight into [H, W]: no untile pass.
//
// Window: the TPU kernel's grid step (t, j) reads the chunk-aligned block
// rows [(start/chunk + j)*chunk, +chunk) masked to [start, end), for
// j < nchunks = max_faces_per_tile/chunk + 1. Those blocks, clipped, are
// one run of rows, [start, min(end, (start/chunk + nchunks)*chunk)); here
// one block per tile walks that run. A tile with more pairs than the
// window holds keeps the window's first rows only, as on the TPU.
//
// Design: one thread per pixel, each keeping its best (z, face) in
// registers. The window's rows and their face ids are staged in shared
// memory at once (17 floats a row, so a lane that reads its own row meets
// no bank conflict; up to 320 rows, 24 KB, else in pieces of 320): one
// load latency and one barrier a tile, also for the few tiles whose
// window is full (the first design staged chunk by chunk, and those tiles
// set its tail). A strict `<` in row order keeps the earliest row among
// equal depths, the TPU kernel's tie rule (it takes the minimum row index
// among equal depths in a sub-chunk, then a strict `<` across
// sub-chunks).
//
// Warp regions and the cull: where the tile size is a multiple of 8 a warp
// owns an 8x4 region of the tile (lane l at column l % 8, row l / 8; 8
// warps a 16x16 tile, 32 a 32x32 one); otherwise the threads take the
// tile's pixels in row order and a warp's region is the bounding box of
// its pixels (threads past the tile's last pixel own none and write
// nothing; the block is rounded up to whole warps). For each 32 staged
// rows, lane r tests row r against its warp's region; `__ballot_sync`
// gives the rows that may hit one of the region's pixels, and the warp
// evaluates those rows only, in increasing row order, two at a time
// (their arithmetic is independent; the keep tests run in row order). A
// culled (row, pixel) pair would have failed an edge test in the kernel's
// own rounded arithmetic, and a miss never changes (best z, best face), so
// face index and depth stay bit-equal to the plain version and the tie
// rule holds.
//
// The cull test: row s is skipped if |inv_area|*valid == 0 (izp is then 0
// or NaN, and izp > 0 fails), or if for some edge k
//   s_k = a*xc + b*yc + c + |a|*hx + |b|*hy  <  -m_k,
//   m_k = 2^-20 * (|a|*X + |b|*Y + |c|) + 2^-100,  m_k < 2^100,
// with (xc, yc) the centre of the region's pixel centres, (hx, hy) its
// half-extents and (X, Y) = (xc + hx, yc + hy) its largest pixel centre
// (all exact in float32; pixel centres are positive). Each product and
// sum is rounded on its own (__fmul_rn / __fadd_rn, in this order), so
// ops/rasterizer_cuda.py `k5_may_hit` mirrors the decisions bit for bit.
// Derivation, with u = 2^-24 and S = |a|*X + |b|*Y + |c|: the exact largest
// E_k over the region's pixel centres is a*xc + b*yc + c + |a|*hx +
// |b|*hy (a linear function peaks at a corner). The kernel's E_k at a
// pixel, fl(fl(fl(a*px) + fl(b*py)) + c), is within gamma_3 * S of the
// exact value (gamma_n = n*u / (1 - n*u)): each term passes through at
// most 3 roundings and |a*px| + |b*py| + |c| <= S. The computed s_k, five
// terms through at most 5 roundings each, is within gamma_5 * S of the
// exact maximum, since |a*xc| + |a|*hx = |a|*X. So if any pixel of the
// region had E_k >= 0 in the kernel's arithmetic, then s_k >= -(gamma_3 +
// gamma_5) * S ~ -8u * S. The computed m_k is at least 2^-20 * S * (1 -
// gamma_3) ~ 16u * S (a sum of non-negative terms), so s_k < -m_k proves a
// miss at every pixel of the region. The 2^-100 covers the absolute
// rounding of products that underflow (at most 2^-150 each); m_k < 2^100
// keeps every partial sum far from overflow. A NaN or an infinity in a
// row makes s_k or m_k NaN or m_k infinite, so such a row is never
// skipped.
//
// Rounding: the edge functions and izp are discontinuous tests of
// near-equal sums at shared edges, so each product and sum is rounded on
// its own (__fmul_rn / __fadd_rn, no FMA contraction) in the TPU kernel's
// order, and the reciprocal is an IEEE division (__fdiv_rn), for the rows
// that hit only. The plain PyTorch version (ops/rasterizer_cuda.py
// zbuffer_plain) runs the same float32 operations on every row, so the two
// agree bit for bit, depth included.
//
// Bound: per (row, pixel) evaluation 25 float32 operations: 12 for the
// three edge functions, 6 for izp, 1 max, 1 division, 5 comparisons (three
// edges, izp > 0, the keep test). Bytes: 64 per row read per tile and 8 per
// pixel written. On the full-width mesh_vae frame (65,536-face sphere,
// 2048x1334, 10,752 tiles of 16 px, chunk 32, max_faces_per_tile 256) the
// rows in the windows are 177,088 (11.3 MB) and the pixels 2,732,032
// (21.9 MB): 0.0099 ms at 3.35 TB/s, bytes bound. The first design (one
// thread per pixel in row order, every pixel of the tile for every row)
// made 45,334,528 row-pixel evaluations there, against 7,385,053 inside the
// faces' screen boxes. This one makes 12,743,040 (398,220 of the
// 1,416,704 (row, warp) pairs kept, 1.73x the boxes' count), counted by
// the mirror (`zbuffer_plain(..., counts=)`, printed by chip_smoke.py).
// Its time is latency, not work: on an H100 (700 W) the 10,752 blocks with
// every tile empty take ~0.018 ms, the tiles of at most 64 rows alone
// ~0.045 ms, and the 122 tiles of more than 128 rows alone ~0.043 ms, each
// of them one block walking up to 288 rows one warp-row after another;
// they sit at the sphere's poles, up to 80% of the way through the grid,
// and so set the kernel's tail.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the outputs. The launcher allocates nothing, launches on the
// given stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#define ZB_COLS 16
#define ZB_STRIDE 17  // floats a staged row in shared memory
#define ZB_ROW_BYTES (ZB_STRIDE * 4 + 4)  // a staged row and its face id
// shared memory a block stages rows in: 8 blocks of 256 threads an SM fit
// in its 227 KB
#define ZB_STAGE_BYTES (24 * 1024)
#define ZB_BIG 3.0e38f
#define ZB_CULL_REL 9.5367431640625e-07f  // 2^-20
#define ZB_CULL_ABS 7.888609052210118e-31f  // 2^-100
#define ZB_CULL_MAX 1.2676506002282294e+30f  // 2^100

// May row d hit a pixel centre of the region (centre (xc, yc), half-extents
// (hx, hy), largest centre (X, Y))? false only where every pixel of the
// region fails an edge test in the kernel's arithmetic (see the note).
__device__ __forceinline__ bool zb_may_hit(const float* d, float xc,
                                           float yc, float hx, float hy,
                                           float X, float Y) {
  if (d[9] == 0.0f) return false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = d[k], b = d[3 + k], c = d[6 + k];
    const float aa = fabsf(a), ab = fabsf(b);
    const float s = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, xc), __fmul_rn(b, yc)),
                            c),
                  __fmul_rn(aa, hx)),
        __fmul_rn(ab, hy));
    const float m = __fadd_rn(
        __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(aa, X), __fmul_rn(ab, Y)),
                            fabsf(c)),
                  ZB_CULL_REL),
        ZB_CULL_ABS);
    if (m < ZB_CULL_MAX && s < -m) return false;
  }
  return true;
}

// The kernel's per (row, pixel) test: the edge functions and izp, each
// product and sum rounded on its own, in the TPU kernel's order.
__device__ __forceinline__ bool zb_hit(const float* d, float px, float py,
                                       float& izp) {
  const float e0 = __fadd_rn(
      __fadd_rn(__fmul_rn(d[0], px), __fmul_rn(d[3], py)), d[6]);
  const float e1 = __fadd_rn(
      __fadd_rn(__fmul_rn(d[1], px), __fmul_rn(d[4], py)), d[7]);
  const float e2 = __fadd_rn(
      __fadd_rn(__fmul_rn(d[2], px), __fmul_rn(d[5], py)), d[8]);
  izp = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(e0, d[10]), __fmul_rn(e1, d[11])),
                __fmul_rn(e2, d[12])),
      d[9]);
  return e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && izp > 0.0f;
}

// A hit's depth against the pixel's best: a strictly smaller depth wins.
__device__ __forceinline__ void zb_keep(float izp, int face, float& best_z,
                                        int& best_face) {
  const float zp = __fdiv_rn(1.0f, fmaxf(izp, 1e-12f));
  if (zp < best_z) {
    best_z = zp;
    best_face = face;
  }
}

__global__ void __launch_bounds__(1024)
zbuffer_kernel(const float* __restrict__ rows,
               const int32_t* __restrict__ sorted_prim,
               const int32_t* __restrict__ tile_start,
               const int32_t* __restrict__ tile_end, int ntx, int tile_size,
               int img_h, int img_w, int chunk, int nchunks, int stage_rows,
               int32_t* __restrict__ index_img, float* __restrict__ z_img) {
  // [stage_rows, ZB_STRIDE] rows, then [stage_rows] face ids
  extern __shared__ float s_rows[];
  int32_t* s_face = (int32_t*)(s_rows + stage_rows * ZB_STRIDE);
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_pix = tile_size * tile_size;
  const int start = tile_start[t];
  const int end = tile_end[t];
  // the thread's pixel and its warp's region [rx0, rx1] x [ry0, ry1], in
  // the tile
  int lx, ly, rx0, rx1, ry0, ry1;
  if (tile_size % 8 == 0) {
    rx0 = (warp % (tile_size / 8)) * 8;
    ry0 = (warp / (tile_size / 8)) * 4;
    rx1 = rx0 + 7;
    ry1 = ry0 + 3;
    lx = rx0 + (lane & 7);
    ly = ry0 + (lane >> 3);
  } else {
    lx = p % tile_size;
    ly = p / tile_size;
    const int first = warp * 32;
    const int last = min(first + 31, n_pix - 1);
    ry0 = first / tile_size;
    ry1 = last / tile_size;
    rx0 = ry0 == ry1 ? first % tile_size : 0;
    rx1 = ry0 == ry1 ? last % tile_size : tile_size - 1;
  }
  const int tx0 = (t % ntx) * tile_size;
  const int ty0 = (t / ntx) * tile_size;
  const int gx = tx0 + lx;
  const int gy = ty0 + ly;
  const float px = (float)gx + 0.5f;
  const float py = (float)gy + 0.5f;
  const float xc = (float)(2 * tx0 + rx0 + rx1 + 1) * 0.5f;
  const float yc = (float)(2 * ty0 + ry0 + ry1 + 1) * 0.5f;
  const float hx = (float)(rx1 - rx0) * 0.5f;
  const float hy = (float)(ry1 - ry0) * 0.5f;
  const float X = (float)(tx0 + rx1) + 0.5f;
  const float Y = (float)(ty0 + ry1) + 0.5f;

  float best_z = ZB_BIG;
  int best_face = -1;
  // the window's blocks, clipped to [start, end), are one run of rows
  const long long w_end = (long long)(start / chunk + nchunks) * chunk;
  const int hi = w_end < end ? (int)w_end : end;
  for (int lo = start; lo < hi; lo += stage_rows) {
    const int n = min(stage_rows, hi - lo);
    __syncthreads();  // the previous piece's reads of the stage are done
    const float4* src = reinterpret_cast<const float4*>(rows) +
                        (long long)lo * (ZB_COLS / 4);
    for (int i = p; i < n * (ZB_COLS / 4); i += blockDim.x) {
      const float4 q = src[i];
      float* dst = s_rows + (i / 4) * ZB_STRIDE + (i % 4) * 4;
      dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
    }
    for (int i = p; i < n; i += blockDim.x) s_face[i] = sorted_prim[lo + i];
    __syncthreads();
    for (int g = 0; g < n; g += 32) {
      const int r = g + lane;
      const bool may = r < n && zb_may_hit(s_rows + r * ZB_STRIDE, xc, yc,
                                           hx, hy, X, Y);
      unsigned mask = __ballot_sync(0xffffffffu, may);
      while (mask) {  // warp-uniform; rows in increasing order, two at once
        const int r1 = g + __ffs(mask) - 1;
        mask &= mask - 1u;
        float izp1, izp2;
        const bool h1 = zb_hit(s_rows + r1 * ZB_STRIDE, px, py, izp1);
        if (mask) {
          const int r2 = g + __ffs(mask) - 1;
          mask &= mask - 1u;
          const bool h2 = zb_hit(s_rows + r2 * ZB_STRIDE, px, py, izp2);
          if (h1) zb_keep(izp1, s_face[r1], best_z, best_face);
          if (h2) zb_keep(izp2, s_face[r2], best_z, best_face);
        } else if (h1) {
          zb_keep(izp1, s_face[r1], best_z, best_face);
        }
      }
    }
  }

  if (p < n_pix && gx < img_w && gy < img_h) {
    const long long pix = (long long)gy * img_w + gx;
    index_img[pix] = best_z < ZB_BIG ? best_face : -1;
    z_img[pix] = best_z;
  }
}

// rows: [n_rows, 16] f32; sorted_prim: [n_rows] i32; tile_start/end:
// [n_tiles] i32 with 0 <= start <= end <= n_rows. Returns the launch's CUDA
// error.
extern "C" int goliath_zbuffer(const float* rows, const int32_t* sorted_prim,
                               const int32_t* tile_start,
                               const int32_t* tile_end, int n_tiles, int ntx,
                               int tile_size, int img_h, int img_w, int chunk,
                               int nchunks, int32_t* index_img, float* z_img,
                               cudaStream_t stream) {
  if (tile_size * tile_size > 1024 || chunk < 1 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  // the whole window at once where it fits in ZB_STAGE_BYTES, else in
  // pieces of as many whole warps' worth of rows as fit
  const long long window = (long long)nchunks * chunk;
  const long long fit = ZB_STAGE_BYTES / ZB_ROW_BYTES / 32 * 32;
  const int stage_rows = (int)(window < fit ? window : fit);
  const size_t smem = (size_t)stage_rows * ZB_ROW_BYTES;
  const int threads = (tile_size * tile_size + 31) / 32 * 32;
  zbuffer_kernel<<<n_tiles, threads, smem, stream>>>(
      rows, sorted_prim, tile_start, tile_end, ntx, tile_size, img_h, img_w,
      chunk, nchunks, stage_rows, index_img, z_img);
  return (int)cudaGetLastError();
}
