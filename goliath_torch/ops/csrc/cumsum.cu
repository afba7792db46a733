// K4 and K3: inclusive prefix sums along the last axis of a contiguous
// [F, n] array, one independent scan per row.
//
// K4 (int32, F = 1) serves the tile binning (goliath_torch/ops/binning.py,
// twice per render) and replaces the JAX package's ops/gsplat_pallas.py
// `_cumsum1d_kernel` via `cumsum1d_pl`. K3 (float32, F = 6 + C columns of
// per-pair gradients, n = the pair budget) serves the per-prim gradient
// reduce of the compositor backward (goliath_torch/ops/gsplat.py
// `reduce_sorted_pair_grads`) and the sorted scatter-add
// (goliath_torch/ops/scatter.py); it replaces `_cumsum1d_batched_kernel`
// via `cumsum_cols_pl` (pallas_call at gsplat_pallas.py:230).
//
// The TPU kernels walk a sequential grid with an f32 carry in VMEM scratch
// (exact for integers only below 2^24); the batched one packs all F columns
// into one block because each sequential grid step pays a DMA latency.
// Hopper blocks run in no order, so both are the classic three-step scan,
// with the column as the grid's second axis:
//   1. scan_blocks: each block scans 4096 items of one column (1024
//      threads x 4) with warp shuffles and writes its total to scratch;
//   2. the block totals [F, blocks] are scanned by the same routine
//      (recursively);
//   3. add_offsets adds the scanned total of the blocks before each block.
// The int32 carry is exact over the whole int32 range (it wraps where
// torch.cumsum(dtype=int32) wraps). Float addition is not associative: K3
// adds in this tree order, torch.cumsum in its own, so the two agree to
// rounding, a few ulp of the largest running sum of the column.
//
// Bound: bytes. 4 bytes read + 4 written per item in step 1, plus 4 + 4 in
// step 3: a 3M-item int scan moves ~50 MB, ~15 us at 3.35 TB/s; the
// [10, 3M] float scan ~500 MB, ~150 us. The design reads and writes each
// item twice; a single pass with decoupled look-back would halve that and
// is left for a later change.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the scratch (`goliath_cumsum_scratch_len`): the launchers
// allocate nothing, launch on the given stream and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 1024
#define SCAN_ITEMS 4
#define SCAN_BLOCK (SCAN_THREADS * SCAN_ITEMS)

// `in` and `out` are not __restrict__: the scan of the block totals runs in
// place (in == out). blockIdx.y is the column; columns are n items apart
// and their block totals gridDim.x apart.
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_blocks(const T* in, T* out, T* __restrict__ block_sums, long long n) {
  __shared__ T warp_sums[SCAN_THREADS / 32];
  in += (long long)blockIdx.y * n;
  out += (long long)blockIdx.y * n;
  const long long base = (long long)blockIdx.x * SCAN_BLOCK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // each thread scans SCAN_ITEMS consecutive items in registers. Every
  // item is read and written by the same thread only, and every read comes
  // before the barriers below, so in == out is safe.
  T v[SCAN_ITEMS];
  T local = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long idx = base + (long long)tid * SCAN_ITEMS + i;
    local += (idx < n) ? in[idx] : T(0);
    v[i] = local;
  }

  // inclusive scan of the thread totals within the warp
  T x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();

  // inclusive scan of the 32 warp totals by warp 0
  if (warp == 0) {
    T s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();

  const T prefix = (x - local) + (warp > 0 ? warp_sums[warp - 1] : T(0));
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long idx = base + (long long)tid * SCAN_ITEMS + i;
    if (idx < n) out[idx] = v[i] + prefix;
  }
  if (block_sums != nullptr && tid == 0)
    block_sums[(long long)blockIdx.y * gridDim.x + blockIdx.x] =
        warp_sums[SCAN_THREADS / 32 - 1];
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
add_offsets(T* __restrict__ out, const T* __restrict__ scanned, long long n) {
  if (blockIdx.x == 0) return;
  out += (long long)blockIdx.y * n;
  const T off = scanned[(long long)blockIdx.y * gridDim.x + blockIdx.x - 1];
  const long long base = (long long)blockIdx.x * SCAN_BLOCK;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long idx = base + (long long)i * SCAN_THREADS + threadIdx.x;
    if (idx < n) out[idx] += off;
  }
}

// Scratch items the scan of one column of n items needs: the block totals
// of every level above the first. F columns need F times as many.
extern "C" long long goliath_cumsum_scratch_len(long long n) {
  const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  return nb <= 1 ? 0 : nb + goliath_cumsum_scratch_len(nb);
}

// Inclusive scan of each of the n_cols rows of in[n_cols, n] into out.
// Returns the first CUDA error of the launches (0 on success).
template <typename T>
static int cumsum_cols(const T* in, T* out, T* scratch, int n_cols,
                       long long n, cudaStream_t stream) {
  if (n <= 0 || n_cols <= 0) return 0;
  if (n_cols > 65535) return (int)cudaErrorInvalidValue;  // grid y limit
  const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  const dim3 grid((unsigned)nb, (unsigned)n_cols);
  scan_blocks<T><<<grid, SCAN_THREADS, 0, stream>>>(
      in, out, nb > 1 ? scratch : nullptr, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return (int)err;
  // the block totals form a contiguous [n_cols, nb] array
  const int rec = cumsum_cols<T>(scratch, scratch, scratch + n_cols * nb,
                                 n_cols, nb, stream);
  if (rec != 0) return rec;
  add_offsets<T><<<grid, SCAN_THREADS, 0, stream>>>(out, scratch, n);
  return (int)cudaGetLastError();
}

// K4. `scratch` holds at least goliath_cumsum_scratch_len(n) int32.
extern "C" int goliath_cumsum_i32(const int32_t* in, int32_t* out,
                                  int32_t* scratch, long long n,
                                  cudaStream_t stream) {
  return cumsum_cols<int32_t>(in, out, scratch, 1, n, stream);
}

// K3. in/out: [n_cols, n] f32; `scratch` holds at least
// n_cols * goliath_cumsum_scratch_len(n) floats.
extern "C" int goliath_cumsum_cols_f32(const float* in, float* out,
                                       float* scratch, int n_cols,
                                       long long n, cudaStream_t stream) {
  return cumsum_cols<float>(in, out, scratch, n_cols, n, stream);
}
