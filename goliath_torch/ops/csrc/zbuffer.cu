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
// j < nchunks = max_faces_per_tile/chunk + 1. Here one block per tile walks
// the same blocks, clipped to [start, end), and stops at the first block at
// or past `end`. A tile with more pairs than the window holds keeps the
// window's first rows only, as on the TPU.
//
// Design: one thread per pixel (256 at tile 16), each keeping its best
// (z, row) in registers; the rows of each block are staged in shared memory
// and read by all threads as broadcasts. A strict `<` in row order keeps
// the earliest row among equal depths, the TPU kernel's tie rule (it takes
// the minimum row index among equal depths in a sub-chunk, then a strict
// `<` across sub-chunks).
//
// Rounding: the edge functions and izp are discontinuous tests of
// near-equal sums at shared edges, so each product and sum is rounded on
// its own (__fmul_rn / __fadd_rn, no FMA contraction) in the TPU kernel's
// order, and the reciprocal is an IEEE division (__fdiv_rn). The plain
// PyTorch version (ops/rasterizer_cuda.py zbuffer_plain) runs the same
// float32 operations, so the two agree bit for bit, depth included.
//
// Bound: per (row, pixel) evaluation 25 float32 operations: 12 for the
// three edge functions, 6 for izp, 1 max, 1 division, 5 comparisons (three
// edges, izp > 0, the keep test). Bytes: 64 per row read per tile and 8 per
// pixel written. A full-width mesh_vae frame (65,536 faces, 2048x1334) has
// ~2-3e5 pairs, i.e. ~6e7 evaluations (~1.5 GFLOP, ~0.02 ms at 67 TFLOP/s)
// and ~35 MB (~0.01 ms at 3.35 TB/s): either way a few tens of
// microseconds, so launch latency and the one-block-per-tile tail matter
// more than either. Pixels of a tile stay busy for every row of the tile,
// also those outside the face's bounding box; a later change can cull rows
// per warp.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the outputs. The launcher allocates nothing, launches on the
// given stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#define ZB_COLS 16
#define ZB_BIG 3.0e38f

__global__ void __launch_bounds__(1024)
zbuffer_kernel(const float* __restrict__ rows,
               const int32_t* __restrict__ sorted_prim,
               const int32_t* __restrict__ tile_start,
               const int32_t* __restrict__ tile_end, int ntx, int tile_size,
               int img_h, int img_w, int chunk, int nchunks,
               int32_t* __restrict__ index_img, float* __restrict__ z_img) {
  extern __shared__ float s_rows[];  // [chunk, 16]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int gx = (t % ntx) * tile_size + p % tile_size;
  const int gy = (t / ntx) * tile_size + p / tile_size;
  const float px = (float)gx + 0.5f;
  const float py = (float)gy + 0.5f;

  float best_z = ZB_BIG;
  int best_s = -1;
  const int first = start / chunk;
  for (int j = 0; j < nchunks; ++j) {
    const int base = (first + j) * chunk;
    if (base >= end) break;  // block-uniform
    const int lo = base > start ? base : start;
    const int hi = (base + chunk) < end ? (base + chunk) : end;
    const int n = hi - lo;
    __syncthreads();  // the previous block's reads of s_rows are done
    for (int i = p; i < n * ZB_COLS; i += blockDim.x)
      s_rows[i] = rows[(long long)lo * ZB_COLS + i];
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float* d = s_rows + r * ZB_COLS;
      const float e0 = __fadd_rn(
          __fadd_rn(__fmul_rn(d[0], px), __fmul_rn(d[3], py)), d[6]);
      const float e1 = __fadd_rn(
          __fadd_rn(__fmul_rn(d[1], px), __fmul_rn(d[4], py)), d[7]);
      const float e2 = __fadd_rn(
          __fadd_rn(__fmul_rn(d[2], px), __fmul_rn(d[5], py)), d[8]);
      const float izp = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(e0, d[10]), __fmul_rn(e1, d[11])),
                    __fmul_rn(e2, d[12])),
          d[9]);
      const bool hit = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && izp > 0.0f;
      const float zp = hit ? __fdiv_rn(1.0f, fmaxf(izp, 1e-12f)) : ZB_BIG;
      if (zp < best_z) {
        best_z = zp;
        best_s = lo + r;
      }
    }
  }

  if (gx < img_w && gy < img_h) {
    const long long pix = (long long)gy * img_w + gx;
    index_img[pix] = (best_z < ZB_BIG && best_s >= 0) ? sorted_prim[best_s]
                                                     : -1;
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
  if (tile_size * tile_size > 1024 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)chunk * ZB_COLS * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        zbuffer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  zbuffer_kernel<<<n_tiles, tile_size * tile_size, smem, stream>>>(
      rows, sorted_prim, tile_start, tile_end, ntx, tile_size, img_h, img_w,
      chunk, nchunks, index_img, z_img);
  return (int)cudaGetLastError();
}
